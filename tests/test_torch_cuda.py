"""tpuenc_torch's CUDA kernels against their plain PyTorch versions on the
card, bit for bit (tolerance 0: integer arithmetic throughout).

Marked ``cuda``: each test skips without an NVIDIA GPU.  This file imports
no JAX, so it also runs where JAX is not installed; there the repo's
conftest (which imports JAX) is left out:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tpuenc_torch.core.tables import default_tables, quantization_table
from tpuenc_torch.entropy import pallas_pack as tpack
from tpuenc_torch.entropy.device_encode import (
    _dc_prev_delta,
    params_from_numpy,
    tables_to_arrays,
)
from tpuenc_torch.entropy.device_pack import ScanSpec
from tpuenc_torch.kernels import pallas_fdct as tfdct
from tpuenc_torch.testing.fixtures import build_cases, img

pytestmark = pytest.mark.cuda

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _params(device, quality=90):
    q = [quantization_table("default", quality, True),
         quantization_table("default", quality, False)]
    huffman = [list(p) for p in default_tables()]
    return params_from_numpy(q, *tables_to_arrays(huffman), device)


@pytest.mark.parametrize("quality", [1, 50, 90, 100])
def test_k1_matches_plain(dev, quality):
    rng = np.random.default_rng(quality)
    x = rng.integers(-128, 128, (64, 3001)).astype(np.int32)
    x[:, :3] = -128
    x[:, 3:6] = 127
    p = _params(dev, quality)
    xs = torch.from_numpy(x).to(dev)
    n = tfdct.fdct_quantize.launches
    for t in (0, 1):
        got = tfdct.fdct_quantize(xs, p.reciprocals[t], p.corrections[t])
        torch.cuda.synchronize()
        want = tfdct.fdct_quantize_ref(xs, p.reciprocals[t], p.corrections[t])
        assert torch.equal(got, want)
    assert tfdct.fdct_quantize.launches == n + 2


@pytest.mark.parametrize("B", [1, 31, 32, 33, 4097, 56250])
def test_k1_edge_widths_write_every_word(dev, B):
    """K1 at widths that leave its tiles of 32 blocks ragged (and B % 4 !=
    0): its output lands on a block the allocator holds dirty, and still
    equals the plain version."""
    rng = np.random.default_rng(B)
    x = torch.from_numpy(rng.integers(-128, 128, (64, B)).astype(np.int32)).to(dev)
    p = _params(dev, 75)
    r, c = p.reciprocals[0], p.corrections[0]
    want = tfdct.fdct_quantize_ref(x, r, c)
    torch.cuda.synchronize()
    dirty = torch.full((64, B), -1, dtype=torch.int16, device=dev)
    ptr = dirty.data_ptr()
    del dirty
    got = tfdct.fdct_quantize(x, r, c)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr
    assert torch.equal(got, want)


def _spec(pattern, tabs, seg, ss=1, se=64, emit_dc=True):
    t = tuple(tabs[c] for c in pattern)
    return ScanSpec(ss, se, emit_dc, True, t, t, _dc_prev_delta(pattern), seg)


SPECS = [
    _spec((0, 1, 2), (0, 1, 1), 0),
    _spec((0, 0, 0, 0, 1, 2), (0, 0, 0, 0, 1, 1), 18),
    _spec((0, 1, 2, 3), (1, 1, 1, 0), 0),
    _spec((0,), (0,), 5),
    _spec((0,), (1,), 0, ss=6, se=40, emit_dc=False),
    # The longest table pattern K2 takes: 16 blocks, four components.
    _spec((0,) * 4 + (1,) * 4 + (2,) * 4 + (3,) * 4, (0, 1, 1, 0), 48),
]


def _blocks(B, seed, extremes=False):
    """Sparse and dense blocks; those at 10-13 overflow rung 16.  With
    ``extremes``, blocks 5 and 9 hold the largest magnitudes: size 15
    items, and -32768 (size 16, whose bit overlaps the run's low bit in
    the symbol) after a run of 15 zeros and right after the DC; block 6
    (luma in the 3-block pattern) holds 63 size-10 items, 26 bits each
    with the default luma table, which overflow block budgets 16 and 48
    (224 has room)."""
    rng = np.random.default_rng(seed)
    q = np.zeros((64, B), np.int16)
    mask = rng.random((64, B)) < 0.2
    q[mask] = rng.integers(-300, 300, (64, B))[mask]
    q[0] = rng.integers(-1000, 1000, B)
    q[1:40, 1::7] = 0
    q[:, 3::11] = rng.integers(-60, 60, (64, q[:, 3::11].shape[1]))
    q[:, 10:14] = rng.integers(-900, 900, (64, 4))  # overflow rung 16
    if extremes:
        q[:, 5] = np.where(np.arange(64) % 2 == 0, 32767, -32767)
        q[1:16, 5] = 0
        q[16, 5] = -32768
        q[:, 9] = -32768
        q[0, 7] = 32767
        q[1:, 6] = np.where(np.arange(1, 64) % 2 == 0, 1023, -1023)
    return q


# name: (spec index, B, Bp, extremes).  Every B ends inside a thread
# block's tile of 128 blocks, with padding rows after it; Bp = 1100 also
# ends the last tile part way.
K2_CASES = {f"spec{i}": (i, 1000, 1024, False) for i in range(len(SPECS))}
K2_CASES.update({
    "spec1_bp_partial_tile": (1, 1001, 1100, False),
    "pattern16_bp_partial_tile": (5, 1003, 1100, False),
    "extremes": (0, 1000, 1024, True),
})


@pytest.mark.parametrize("case", sorted(K2_CASES))
@pytest.mark.parametrize("budget", [16, 48, 224])
def test_k2_matches_plain(dev, case, budget):
    si, B, Bp, extremes = K2_CASES[case]
    spec = SPECS[si]
    p = _params(dev)
    q = torch.from_numpy(_blocks(B, si, extremes)).to(dev)
    dcdiff = tpack.dc_diffs_from_dc(q[0], spec)
    n = tpack.pack_blocks.launches
    got = tpack.pack_blocks(q, dcdiff, p.dc, p.ac, spec, Bp, budget)
    torch.cuda.synchronize()
    want = tpack.pack_blocks_ref(q, dcdiff, p.dc, p.ac, spec, Bp, budget)
    assert tpack.pack_blocks.launches == n + 1
    assert got[0].shape == (Bp, tpack.final_block_cap(budget))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not got[1][B:].any() and not got[0][B:].any()
    if case == "spec0":
        assert bool(got[2].item()) == (budget == 16)
    if extremes:
        assert bool(got[2].item()) == (budget < 224)


def _strings(Bp, capB, seed, mean_bits, clip=True):
    """MSB-aligned random bit strings, zero past their lengths; 10% are
    empty.  Unless ``clip``, a length may pass the row's 32 * capB bits,
    as K2 leaves a block that overflows its cap."""
    rng = np.random.default_rng(seed)
    lens = rng.poisson(mean_bits, Bp)
    if clip:
        lens = np.minimum(lens, 32 * capB)
    lens = lens.astype(np.int32)
    lens[rng.random(Bp) < 0.1] = 0
    words = rng.integers(0, 1 << 32, (Bp, capB), dtype=np.uint64)
    full = np.clip(lens[:, None] - np.arange(capB)[None, :] * 32, 0, 32)
    keep = np.where(full >= 32, 0xFFFFFFFF, ((1 << full) - 1) << (32 - full))
    words = (words & keep.astype(np.uint64)).astype(np.uint32).view(np.int32)
    return words, lens


# name: (run, n_runs, C_in, mean bits per row, budget, options).  The
# input has run * n_runs - short rows (short 37 unless given), so the last
# runs are cut short; options: clip=False lets rows pass 32 * C_in bits,
# empty_runs zeroes every other run, cap_out / caps replace the P2 plan's
# (chunk_caps; fold_caps with fold=True), ovf is the flag it must give.
MERGES = {
    "p2": (8, 80, 19, 150, 16, {}),
    "p2_flagship_rung5": (256, 128, 19, 130, 5, {}),
    "p3_overflow": (6, 128, 19, 590, 5, {"clip": False, "ovf": 1}),
    "rows_past_c_in": (8, 40, 3, 200, 16, {"clip": False}),
    "one_to_six_bit_rows": (256, 24, 1, 3, 5, {}),
    "empty_runs": (16, 30, 5, 60, 16, {"empty_runs": True}),
    "all_empty": (16, 30, 5, 0, 16, {"ovf": 0}),
    "past_cap_out": (16, 30, 5, 150, 16, {"cap_out": 7, "caps": [2] * 4,
                                           "ovf": 1}),
    "run_1": (1, 300, 19, 150, 16, {}),
    "run_6000": (6000, 3, 2, 20, 5, {}),
    "p3_flagship": (6, 128, 1536, 33000, 5, {"fold": True, "short": 0}),
}


@pytest.mark.parametrize("case", sorted(MERGES))
def test_k3_k4_match_plain(dev, case):
    """Both wrappers of the merge kernel against its plain version: words
    (the zero tail included), lengths and the flag."""
    run, n_runs, c_in, mean_bits, budget, opt = MERGES[case]
    words, lens = _strings(run * n_runs - opt.get("short", 37), c_in, run,
                           mean_bits, opt.get("clip", True))
    if opt.get("empty_runs"):
        lens.reshape(-1)[:(len(lens) // run) * run].reshape(-1, run)[::2] = 0
        words[lens == 0] = 0
    w = torch.from_numpy(words).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    n_chunks = 1 << (run - 1).bit_length()
    if opt.get("fold"):
        caps = tpack.fold_caps(c_in, n_chunks, budget * 256)
    else:
        caps = tpack.chunk_caps(c_in, n_chunks, budget)
    caps = opt.get("caps", caps)
    cap_out = opt.get("cap_out", caps[-1] if caps else c_in)
    want = tpack.merge_rows_ref(w, ln, run, n_runs, caps, cap_out)
    if "ovf" in opt:
        assert int(want[2].item()) == opt["ovf"]
    for fn in (tpack.merge_chunks, tpack.fold_rows):
        n = fn.launches
        got = fn(w, ln, run, n_runs, caps, cap_out)
        torch.cuda.synchronize()
        assert fn.launches == n + 1
        for g, x in zip(got, want):
            assert torch.equal(g, x)


def test_k5_matches_plain(dev):
    rows, bits = _strings(128, 700, 3, 9000)
    r = torch.from_numpy(rows).to(dev)
    b = torch.from_numpy(bits).to(dev)
    pos = torch.cumsum(b.to(torch.int64), 0) - b
    capW = 128 * 700 + 1024
    n = tpack.concat_rows.launches
    got = tpack.concat_rows(r, pos, b, capW)
    torch.cuda.synchronize()
    assert tpack.concat_rows.launches == n + 1
    assert torch.equal(got, tpack.concat_rows_ref(r, pos, b, capW))



# name: (R, W, mean bits per row, capW past R * W, options).  Rows come
# from _strings (10% empty); options: empty = row slices set empty,
# mult32 = lengths rounded down to multiples of 32, full = rows whose
# length fills all W words (and one past them, as an overflowed P3 row
# is), capW = the stream's words outright (short of the data: the words
# past it are dropped).
CONCATS = {
    "one_row": (1, 700, 9000, 1024, {}),
    "empty_middle_and_end": (300, 20, 300, 256,
                             {"empty": [slice(100, 160), slice(260, 300)]}),
    "multiples_of_32": (200, 16, 250, 256, {"mult32": True}),
    "full_rows": (64, 30, 500, 256, {"full": [0, 10, 11, 63]}),
    "no_p3_12000_rows": (12000, 40, 600, 256, {}),
    "tail_far_past_data": (16, 8, 100, 100000, {}),
    "cap_short_of_data": (96, 30, 900, 0, {"capW": 1000}),
}


def _concat_case(case):
    R, W, mean_bits, tail, opt = CONCATS[case]
    rows, bits = _strings(R, W, R + W, mean_bits, clip=False)
    bits = np.minimum(bits, 32 * W)
    for s in opt.get("empty", []):
        bits[s] = 0
    if opt.get("mult32"):
        bits = bits // 32 * 32
    for i, r in enumerate(opt.get("full", [])):
        bits[r] = 32 * W + (37 if i == 2 else 0)
    # Zero past each length, as P2/P3 leave their rows.
    bit = np.arange(W)[None, :] * 32
    full = np.clip(bits[:, None] - bit, 0, 32).astype(np.uint64)
    keep = np.where(full >= 32, 0xFFFFFFFF, ((1 << full) - 1) << (32 - full))
    rows = (rows.view(np.uint32) & keep.astype(np.uint32)).view(np.int32)
    capW = opt.get("capW", R * W + tail)
    return rows, bits.astype(np.int32), capW


@pytest.mark.parametrize("case", sorted(CONCATS))
def test_k5_shapes_match_plain(dev, case):
    """K5 against its plain version: one row, empty rows at the end and in
    the middle, lengths that are multiples of 32, rows that fill (or pass)
    all W words, the no-P3 shape of ~12,000 rows, a tail far past the
    data, and a stream shorter than the data."""
    rows, bits, capW = _concat_case(case)
    r = torch.from_numpy(rows).to(dev)
    b = torch.from_numpy(bits).to(dev)
    pos = torch.cumsum(b.to(torch.int64), 0) - b
    n = tpack.concat_rows.launches
    got = tpack.concat_rows(r, pos, b, capW)
    torch.cuda.synchronize()
    assert tpack.concat_rows.launches == n + 1
    assert torch.equal(got, tpack.concat_rows_ref(r, pos, b, capW))


def test_k5_writes_every_word(dev):
    """The K5 wrapper allocates without a zero fill: its output lands on a
    block the allocator holds dirty, and still equals the plain version."""
    rows, bits = _strings(128, 64, 5, 1500)
    r = torch.from_numpy(rows).to(dev)
    b = torch.from_numpy(bits).to(dev)
    pos = torch.cumsum(b.to(torch.int64), 0) - b
    capW = 128 * 64 + 4096
    want = tpack.concat_rows_ref(r, pos, b, capW)
    torch.cuda.synchronize()
    dirty = torch.full((capW,), -1, dtype=torch.int32, device=dev)
    ptr = dirty.data_ptr()
    del dirty
    got = tpack.concat_rows(r, pos, b, capW)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr
    assert torch.equal(got, want)

ACBANDS = [
    ((1, 22), (22, 43), (43, 64)),            # the flagship's 4-scan plan
    ((1, 6), (6, 11), (11, 16), (16, 21)),    # four bands of a 13-scan plan
    ((1, 64),),                               # one band over every AC slot
    ((1, 9), (9, 18), (18, 27), (27, 36), (36, 45), (45, 54), (54, 64)),
    ((22, 43), (1, 22), (43, 64)),            # out of slot order
    ((63, 64),),                              # the last slot alone
]


@pytest.mark.parametrize("bi", range(len(ACBANDS)))
@pytest.mark.parametrize("budget", [16, 48, 224])
def test_k6_matches_plain(dev, bi, budget):
    """Words, lengths and the flag; the dense blocks overflow rung 16."""
    bands = ACBANDS[bi]
    p = _params(dev)
    q = torch.from_numpy(_blocks(1000, bi)).to(dev)
    n = tpack.pack_acbands.launches
    got = tpack.pack_acbands(q, bands, p.ac, 1, 1024, budget)
    torch.cuda.synchronize()
    want = tpack.pack_acbands_ref(q, bands, p.ac, 1, 1024, budget)
    assert tpack.pack_acbands.launches == n + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if bi == 0:
        assert bool(got[2].item()) == (budget == 16)


def _dense(B, seed):
    """Blocks whose every AC slot holds a size 8-10 magnitude."""
    rng = np.random.default_rng(seed)
    q = rng.integers(200, 1000, (64, B)).astype(np.int16)
    return q * np.where(rng.random((64, B)) < 0.5, -1, 1).astype(np.int16)


# name: (bands, B, Bp, budget, blocks).  1001 rows of 11 words put band
# 1's rows off a 16-byte boundary (p1_store's 4-byte path); the last case
# is seven bands, one 65 words wide at 224, the largest tile (past the
# default 48 KB of shared memory).
K6_SHAPES = {
    "one_block": (ACBANDS[0], 1, 1, 16, "mixed"),
    "one_block_padded": (ACBANDS[0], 1, 130, 16, "mixed"),
    "bp_partial_tile": (ACBANDS[0], 1001, 1100, 48, "mixed"),
    "bp_unaligned_bands": (ACBANDS[0], 999, 1001, 16, "mixed"),
    "all_zero_eob_only": (ACBANDS[0], 500, 512, 16, "zero"),
    "dense_overflow": (ACBANDS[0], 300, 384, 16, "dense"),
    "bands_with_gaps": (((1, 5), (63, 64), (10, 20)), 700, 768, 16, "mixed"),
    "seven_bands_65_words": (((1, 34), (34, 36), (36, 40), (40, 48), (48, 56),
                              (56, 60), (60, 64)), 700, 768, 224, "mixed"),
}


@pytest.mark.parametrize("case", sorted(K6_SHAPES))
def test_k6_shapes_match_plain(dev, case):
    bands, B, Bp, budget, kind = K6_SHAPES[case]
    p = _params(dev)
    q = {"mixed": lambda: _blocks(max(B, 20), 11)[:, 9:9 + B] if B < 20
         else _blocks(B, 11),
         "zero": lambda: np.zeros((64, B), np.int16),
         "dense": lambda: _dense(B, 5)}[kind]()
    q = torch.from_numpy(np.ascontiguousarray(q)).to(dev)
    got = tpack.pack_acbands(q, bands, p.ac, 0, Bp, budget)
    torch.cuda.synchronize()
    want = tpack.pack_acbands_ref(q, bands, p.ac, 0, Bp, budget)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if kind == "zero":
        eob_len = int(p.ac[0, 0].item()) >> 16
        assert (got[1][:, :B] == eob_len).all()
    if kind == "dense":
        assert got[2].item() == 1


def test_k6_empty_band_and_dc_path(dev):
    """A K6 batch with the empty band [1, 1) of a 34-scan plan, and the
    DC-only pack, on the card and the CPU."""
    from tpuenc_torch.entropy.huffopt import progressive_bands

    p = _params(dev)
    q = _blocks(700, 7)
    specs = [ScanSpec(ss, se, False, True, (0,), (0,), (1,), 0)
             for ss, se in progressive_bands(34)[:4]]
    outs = {}
    for d in (dev, "cpu"):
        pd = _params(d)
        outs[str(d)] = tpack.scan_pack_blocks_acbands(
            torch.from_numpy(q).to(d), specs, pd.ac, 16)
    (gw, gl), (cw, cl) = outs[str(dev)][0][0], outs["cpu"][0][0]
    assert not gl.any() and not gw.any()
    for (gw, gl), (cw, cl) in zip(outs[str(dev)][0], outs["cpu"][0]):
        assert torch.equal(gw.cpu(), cw) and torch.equal(gl.cpu(), cl)
    dc_spec = ScanSpec(1, 1, True, False, (0,), (0,), (1,), 5)
    got = tpack.dc_only_pack_blocks(torch.from_numpy(q).to(dev), dc_spec, p.dc)
    want = tpack.dc_only_pack_blocks(torch.from_numpy(q), dc_spec,
                                     _params("cpu").dc)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n_bands", [1, 3, 8])
def test_k7_matches_plain(dev, n_bands):
    from tpuenc_torch.entropy import pallas_hist as th
    from tpuenc_torch.entropy.huffopt import progressive_bands

    bands = progressive_bands(n_bands + 1)
    q = torch.from_numpy(_blocks(3001, n_bands)).to(dev)
    n = th.hist_count.launches
    got = th.hist_count(q, bands)
    torch.cuda.synchronize()
    assert th.hist_count.launches == n + 1
    assert torch.equal(got, th.hist_count_ref(q, bands))


# name: (bands, B, blocks).  All-zero blocks count only EOBs; in the dense
# ones every lane of a warp hits the same bin at every slot; 300,000
# blocks are more than one resident wave of thread blocks, so the grid
# strides.
K7_SHAPES = {
    "all_zero": (((1, 21), (21, 42), (42, 64)), 5000, "zero"),
    "dense_same_bin": (((1, 21), (21, 42), (42, 64)), 5000, "ones"),
    "dense": (((1, 21), (21, 42), (42, 64)), 3000, "dense"),
    "one_block": (((1, 21), (21, 42), (42, 64)), 1, "mixed"),
    "grid_strides": (((1, 21), (21, 42), (42, 64)), 300_000, "mixed"),
    "eight_bands_reversed": (((56, 64), (48, 56), (40, 48), (32, 40),
                              (24, 32), (16, 24), (8, 16), (1, 8)), 3001,
                             "mixed"),
    "out_of_order": (((22, 43), (1, 22), (43, 64)), 3001, "mixed"),
    "bands_with_gaps": (((1, 5), (63, 64), (10, 20)), 3001, "mixed"),
}


@pytest.mark.parametrize("case", sorted(K7_SHAPES))
def test_k7_shapes_match_plain(dev, case):
    from tpuenc_torch.entropy import pallas_hist as th

    bands, B, kind = K7_SHAPES[case]
    q = {"mixed": lambda: _blocks(max(B, 20), 13)[:, 9:9 + B] if B < 20
         else _blocks(B, 13),
         "zero": lambda: np.zeros((64, B), np.int16),
         "ones": lambda: np.ones((64, B), np.int16),
         "dense": lambda: _dense(B, 6)}[kind]()
    q = torch.from_numpy(np.ascontiguousarray(q)).to(dev)
    got = th.hist_count(q, bands)
    torch.cuda.synchronize()
    want = th.hist_count_ref(q, bands)
    assert torch.equal(got, want)
    if kind == "zero":
        assert (got[:, 273] == B).all() and not got[:, :273].any()


@pytest.mark.parametrize("band", [(1, 64), (6, 40), (63, 64)])
def test_k9_matches_plain(dev, band):
    from tpuenc_torch.entropy import pallas_hist as th

    q = torch.from_numpy(_blocks(1300, band[0])).to(dev)
    n = th.hist_sym.launches
    got = th.hist_sym(q, *band, 1536)
    torch.cuda.synchronize()
    assert th.hist_sym.launches == n + 1
    for g, w in zip(got, th.hist_sym_ref(q, *band, 1536)):
        assert torch.equal(g, w)
    hist = th.ac_histogram_sym(q, *band)
    assert torch.equal(hist, th.ac_histograms_multiband(q, [band])[0])


@pytest.mark.parametrize("band", [(1, 64), (6, 40), (63, 64), (0, 64)])
@pytest.mark.parametrize("lp", ["n", "x512", "n+3"])
@pytest.mark.parametrize("n_blocks", [1, 511, 513, 514])
def test_k9_shapes_match_plain(dev, n_blocks, lp, band):
    """K9 at odd widths (its 2-byte load path) and an even one (staged,
    n_blocks % 4 == 2 as at the flagship), at Lp a multiple of 512 (4-byte
    stores) or not, and at bands from slot 0 and of one slot; the outputs
    reuse blocks the allocator holds from a call on other data."""
    from tpuenc_torch.entropy import pallas_hist as th

    Lp = {"n": n_blocks, "x512": -(-n_blocks // 512) * 512,
          "n+3": n_blocks + 3}[lp]
    q = _blocks(max(n_blocks, 16), n_blocks + band[0], extremes=True)
    q = torch.from_numpy(np.ascontiguousarray(q[:, :n_blocks])).to(dev)
    dense = torch.from_numpy(
        np.random.default_rng(3).integers(-300, 300, (64, n_blocks))
        .astype(np.int16)).to(dev)
    th.hist_sym(dense, 0, 64, Lp)
    got = th.hist_sym(q, *band, Lp)
    torch.cuda.synchronize()
    for g, w in zip(got, th.hist_sym_ref(q, *band, Lp)):
        assert torch.equal(g, w)


# K8: (block component pattern, quantizer per component, table ids per
# component) for MCUs of 1, 3, 6, 7 and 10 blocks.
FUSED = {
    "luma": ((0,), (0,), (0,)),
    "rgb444": ((0, 1, 2), (0, 1, 1), (0, 1, 1)),
    "rgb420": ((0, 0, 0, 0, 1, 2), (0, 1, 1), (0, 1, 1)),
    "cmyk22": ((0, 0, 0, 0, 1, 2, 3), (0, 1, 1, 0), (0, 1, 1, 0)),
    "ycck420": ((0, 0, 0, 0, 1, 2, 3, 3, 3, 3), (0, 1, 1, 0), (0, 1, 1, 0)),
}


def _fused_case(name, restart_mcus):
    pattern, qt, tabs = FUSED[name]
    spec = _spec(pattern, tabs, restart_mcus * len(pattern))
    return spec, tuple(qt[c] for c in pattern)


def _samples(B, seed, amp=128):
    """Level-shifted int16 (64, B) samples: smooth blocks, noise blocks,
    flat extremes."""
    rng = np.random.default_rng(seed)
    ramp = (np.arange(64) % 8 * 9 - 32)[:, None]
    x = ramp + rng.integers(-12, 12, (64, B))
    x[:, 5::9] = rng.integers(-amp, amp, (64, x[:, 5::9].shape[1]))
    x[:, 1::17] = -128
    x[:, 2::17] = 127
    return np.clip(x, -128, 127).astype(np.int16)


def _split_p1(x, spec, qtabs, p, Bp, budget):
    """K1 with each block's table (one launch per table, columns picked
    per block), the DC differences, then K2: the path K8 replaces."""
    lane_q = torch.tensor(qtabs, device=x.device)[
        torch.arange(x.shape[1], device=x.device) % len(qtabs)]
    x32 = x.to(torch.int32)
    q = torch.where(lane_q == 1,
                    tfdct.fdct_quantize(x32, p.reciprocals[1], p.corrections[1]),
                    tfdct.fdct_quantize(x32, p.reciprocals[0], p.corrections[0]))
    return tpack.pack_blocks(q, tpack.dc_diffs_from_dc(q[0], spec), p.dc, p.ac,
                             spec, Bp, budget)


@pytest.mark.parametrize("name", sorted(FUSED))
@pytest.mark.parametrize("restart_mcus", [0, 2])
@pytest.mark.parametrize("budget", [16, 48, 224])
def test_k8_matches_plain_and_split(dev, name, restart_mcus, budget):
    """K8 == its plain version == K1 -> DC differences -> K2, words,
    lengths and flag, for B = 1003 (no multiple of 128 or of the MCU), with
    restart segments that start inside thread blocks and on their edges."""
    spec, qtabs = _fused_case(name, restart_mcus)
    p = _params(dev)
    x = torch.from_numpy(_samples(1003, len(qtabs) + budget)).to(dev)
    n = tpack.fused_sample_pack.launches
    got = tpack.fused_sample_pack(x, spec, qtabs, p.reciprocals, p.corrections,
                                  p.dc, p.ac, 1024, budget)
    torch.cuda.synchronize()
    assert tpack.fused_sample_pack.launches == n + 1
    want = tpack.fused_sample_pack_ref(x, spec, qtabs, p.reciprocals,
                                       p.corrections, p.dc, p.ac, 1024, budget)
    split = _split_p1(x, spec, qtabs, p, 1024, budget)
    for g, w, s in zip(got, want, split):
        assert torch.equal(g, w) and torch.equal(g, s)
    assert not got[1][1003:].any()



# name: (FUSED case, restart MCUs, B, Bp, block budget).  Bp past B leaves
# padding rows: a tile part filled (1100 is no multiple of 128), whole
# tiles of them (1280), one tile in all (127 of 200).
FUSED_TILES = {
    "bp_not_multiple_of_128": ("rgb444", 0, 1003, 1100, 224),
    "padding_tiles": ("rgb420", 2, 1003, 1280, 16),
    "one_tile": ("luma", 1, 127, 200, 48),
    "ycck420_restart_budget_224": ("ycck420", 1, 1003, 1100, 224),
}


@pytest.mark.parametrize("case", sorted(FUSED_TILES))
def test_k8_tiles_match_plain_and_split(dev, case):
    """K8 == its plain version == K1 -> DC differences -> K2 where the
    output rows pass the blocks: padding rows inside the last tile and in
    whole tiles, Bp no multiple of 128, and the largest tile (budget 224)."""
    name, restart_mcus, B, Bp, budget = FUSED_TILES[case]
    spec, qtabs = _fused_case(name, restart_mcus)
    p = _params(dev)
    x = torch.from_numpy(_samples(B, B + budget)).to(dev)
    n = tpack.fused_sample_pack.launches
    got = tpack.fused_sample_pack(x, spec, qtabs, p.reciprocals, p.corrections,
                                  p.dc, p.ac, Bp, budget)
    torch.cuda.synchronize()
    assert tpack.fused_sample_pack.launches == n + 1
    assert got[0].shape == (Bp, tpack.final_block_cap(budget))
    want = tpack.fused_sample_pack_ref(x, spec, qtabs, p.reciprocals,
                                       p.corrections, p.dc, p.ac, Bp, budget)
    split = _split_p1(x, spec, qtabs, p, Bp, budget)
    for g, w, s in zip(got, want, split):
        assert torch.equal(g, w) and torch.equal(g, s)
    assert not got[1][B:].any() and not got[0][B:].any()

@pytest.mark.parametrize("budget", [16, 48])
def test_k8_overflow_flag(dev, budget):
    """Noise through the flat q100 quantizer overflows the rung-16 block
    caps; the flag, the lengths and the kept words match K1 + K2."""
    spec, qtabs = _fused_case("rgb444", 0)
    q = [quantization_table("flat", 100, True),
         quantization_table("flat", 100, False)]
    p = params_from_numpy(q, *tables_to_arrays(
        [list(t) for t in default_tables()]), dev)
    x = torch.from_numpy(_samples(600, 3, amp=128)).to(dev)
    x[:, 100:140] = torch.from_numpy(np.random.default_rng(4).integers(
        -128, 128, (64, 40)).astype(np.int16)).to(dev)
    got = tpack.fused_sample_pack(x, spec, qtabs, p.reciprocals, p.corrections,
                                  p.dc, p.ac, 640, budget)
    split = _split_p1(x, spec, qtabs, p, 640, budget)
    want = tpack.fused_sample_pack_ref(x, spec, qtabs, p.reciprocals,
                                       p.corrections, p.dc, p.ac, 640, budget)
    assert bool(got[2].item()) == (budget == 16)
    for g, w, s in zip(got, want, split):
        assert torch.equal(g, w) and torch.equal(g, s)


def test_k8_rejects_bad_input(dev):
    spec, qtabs = _fused_case("rgb444", 0)
    p = _params(dev)
    x = torch.zeros((64, 8), dtype=torch.int16, device=dev)
    args = (p.reciprocals, p.corrections, p.dc, p.ac, 128, 16)
    with pytest.raises(ValueError):  # int32 samples
        tpack.fused_sample_pack(x.to(torch.int32), spec, qtabs, *args)
    with pytest.raises(ValueError):  # one quantizer, not (luma, chroma)
        tpack.fused_sample_pack(x, spec, qtabs, p.reciprocals[0],
                                p.corrections[0], p.dc, p.ac, 128, 16)
    with pytest.raises(ValueError):  # pattern of another MCU
        tpack.fused_sample_pack(x, spec, (0, 1), *args)
    with pytest.raises(ValueError):  # a scan without DC items
        tpack.fused_sample_pack(x, SPECS[4], (0,), *args)
    with pytest.raises(ValueError):  # fewer output rows than blocks
        tpack.fused_sample_pack(x, spec, qtabs, *args[:4], 4, 16)


def test_wrappers_reject_bad_input(dev):
    p = _params(dev)
    with pytest.raises(ValueError):
        tfdct.fdct_quantize(torch.zeros((64, 8), dtype=torch.int16, device=dev),
                            p.reciprocals[0], p.corrections[0])
    q = torch.zeros((64, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        tpack.pack_blocks(q, torch.zeros(8, dtype=torch.int32, device=dev),
                          p.dc, p.ac, SPECS[0], 8, 16)
    with pytest.raises(ValueError):
        tpack.concat_rows(torch.zeros((2, 4), dtype=torch.int32, device=dev),
                          torch.zeros(2, dtype=torch.int32, device=dev),
                          torch.zeros(2, dtype=torch.int32, device=dev), 64)


@pytest.mark.parametrize("name", sorted(build_cases("cpu")))
def test_fixtures_on_cuda(dev, name):
    build, ct, ch, seed, w, h = build_cases(dev)[name]
    want = open(os.path.join(HERE, "fixtures", f"{name}.jpg"), "rb").read()
    assert build().encode(img(ch, seed, w, h), w, h, ct) == want


@pytest.mark.parametrize("name", sorted(build_cases("cpu")))
def test_fused_fixtures_on_cuda(dev, name):
    """With fused_p1, the 17 interleaved fixtures go through K8 and the 9
    others through the split path; every file is unchanged."""
    build, ct, ch, seed, w, h = build_cases(dev, fused_p1=True)[name]
    want = open(os.path.join(HERE, "fixtures", f"{name}.jpg"), "rb").read()
    enc = build()
    n = tpack.fused_sample_pack.launches
    assert enc.encode(img(ch, seed, w, h), w, h, ct) == want
    fused = enc._config().mode() == "interleaved"
    assert enc.last_encode_path == ("device-v2-fused" if fused else "device-v2")
    assert (tpack.fused_sample_pack.launches > n) == fused


@pytest.mark.parametrize("w,h,ct,ch,quality,sf,restart,scans,opt", [
    (2048, 1152, "rgb", 3, 90, "F_2_2", 64, None, False),  # 4:2:0 restart64, P3 fold
    (777, 555, "cmyk", 4, 85, "F_2_1", 0, None, False),     # one chunk row: no P3
    (2048, 2048, "luma", 1, 100, "F_1_1", 3, None, False),  # dense q100, P3 fold
    (640, 480, "rgb", 3, 90, "F_1_1", 0, 4, True),          # progressive, K.2 tables
    (320, 200, "ycck", 4, 80, "F_2_2", 5, 64, False),       # 64 scans, empty bands
    (500, 300, "rgb", 3, 85, "F_4_1", 2, None, True),       # sequential, K.2 tables
])
def test_cuda_matches_cpu(dev, w, h, ct, ch, quality, sf, restart, scans, opt):
    """Whole files on the card equal the CPU path's, on both P2-P4
    branches (with the P3 fold, past 32,768 blocks, and without), and in
    the sequential, progressive and optimized-table modes."""
    from tpuenc_torch import ColorType, Encoder, SamplingFactor

    rng = np.random.default_rng(w + h)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 7 + yy * 3) % 256)[..., None]
    px = np.clip(base + rng.integers(-40, 40, (h, w, ch)), 0, 255).astype(np.uint8)
    out = {}
    for d in (dev, "cpu"):
        e = Encoder(quality, device=d)
        e.set_sampling_factor(SamplingFactor[sf])
        e.set_restart_interval(restart)
        if scans:
            e.set_progressive_scans(scans)
        e.set_optimized_huffman_tables(opt)
        out[str(d)] = e.encode(px, w, h, ColorType(ct))
    assert out[str(dev)] == out["cpu"]


def test_config2_frame_on_cuda_matches_cpu_and_reference(dev):
    """BASELINE config 2 whole: a 3840x2160 RGB frame at q80 4:2:0 with a
    restart interval of 64 MCUs (32,400 MCUs, 507 segments, the last of
    16) on the card equals the CPU path's file and the plain reference's
    (``encbench/reference/jpeg.py``, run on the card), with RST0-RST7 in
    turn at all 506 segment boundaries."""
    import re
    import sys

    from tpuenc_torch import ColorType, Encoder, SamplingFactor

    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "encbench"))
    from reference import jpeg

    w, h = 3840, 2160
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 7 + yy * 3) % 256)[..., None]
    px = np.clip(base + rng.integers(-40, 40, (h, w, 3)), 0, 255).astype(np.uint8)
    out = {}
    for d in (dev, "cpu"):
        e = Encoder(80, device=d)
        e.set_sampling_factor(SamplingFactor.from_factors(2, 2))
        e.set_restart_interval(64)
        out[str(d)] = e.encode(px, w, h, ColorType.RGB)
        assert e.last_encode_path == "device-v2"
    assert out[str(dev)] == out["cpu"]
    want = jpeg.encode(px, color_type="rgb", quality=80, sampling=(2, 2),
                       restart_interval=64, device=dev)
    assert out["cpu"] == want
    rst = [m[1] - 0xD0 for m in re.findall(rb"\xff[\xd0-\xd7]", want)]
    assert rst == [i % 8 for i in range(506)]


def _batch_encoder(device, quality, kw):
    from tpuenc_torch import Encoder

    e = Encoder(quality, device=device, fused_p1=kw.get("fused", False))
    e.set_restart_interval(kw.get("restart", 0))
    if kw.get("scans"):
        e.set_progressive_scans(kw["scans"])
    e.set_optimized_huffman_tables(kw.get("opt", False))
    return e


def _batch_images(n, w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 5 + yy * 3) % 256)[..., None]
    return [np.clip(base + rng.integers(-40, 40, (h, w, 3)), 0, 255)
            .astype(np.uint8) for _ in range(n)]


BATCHES = {
    # name: (n, w, h, quality, settings, route)
    "single": (4, 640, 480, 90, {}, "device-batch"),
    "single_420_restart4": (3, 500, 300, 80, {"restart": 4}, "device-batch"),
    "single_fused_p1": (3, 320, 200, 90, {"fused": True}, "device-batch"),
    "per_image_ragged_restart": (3, 500, 300, 90, {"restart": 11},
                                 "device-batch-per-image"),
    "per_image_progressive": (4, 640, 480, 90, {"scans": 4},
                              "device-batch-per-image"),
    "per_image_fused": (4, 640, 480, 90, {"fused": True, "restart": 7},
                        "device-batch-per-image"),
    "per_image_optimized": (2, 640, 480, 90, {"opt": True},
                            "device-batch-per-image"),
}


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_batch_matches_loop_on_cuda(dev, name):
    """Each batch route on the card: every file equals its own encode on
    the card, and the batch equals the CPU path's batch."""
    from tpuenc_torch import ColorType

    n, w, h, q, kw, route = BATCHES[name]
    imgs = _batch_images(n, w, h, seed=len(name))
    enc = _batch_encoder(dev, q, kw)
    got = enc.encode_batch(imgs, w, h, ColorType.RGB)
    assert enc.last_encode_path == route
    loop = _batch_encoder(dev, q, kw)
    assert got == [loop.encode(im, w, h, ColorType.RGB) for im in imgs]
    assert got == _batch_encoder("cpu", q, kw).encode_batch(imgs, w, h,
                                                             ColorType.RGB)


@pytest.mark.parametrize("kw", [{}, {"restart": 11}, {"fused": True,
                                                      "restart": 11}],
                         ids=["single", "per_image", "per_image_fused"])
def test_batch_on_a_side_stream(dev, kw):
    """A batch encoded under another current stream runs its kernels and
    copies on that stream and gives the same files as on the default
    stream."""
    from tpuenc_torch import ColorType

    imgs = _batch_images(3, 500, 300, seed=3)
    want = _batch_encoder(dev, 90, kw).encode_batch(imgs, 500, 300,
                                                     ColorType.RGB)
    side = torch.cuda.Stream(dev)
    enc = _batch_encoder(dev, 90, kw)
    with torch.cuda.stream(side):
        got = enc.encode_batch(imgs, 500, 300, ColorType.RGB)
        assert torch.cuda.current_stream(dev) == side
    assert got == want


def test_pinned_staging_reused_across_batches(dev):
    """The single program's page-locked buffer for its finished bytes is
    allocated once and reused: the same images again, or a smaller batch of them,
    allocate nothing; a larger batch grows it; the files stay per-image
    encode()'s throughout."""
    from tpuenc_torch import ColorType

    enc = _batch_encoder(dev, 90, {})
    imgs = _batch_images(4, 500, 300, seed=4)
    first = enc.encode_batch(imgs, 500, 300, ColorType.RGB)
    assert enc.last_encode_path == "device-batch"
    pinned = enc._pinned
    buf = pinned._buf
    assert buf.is_pinned()
    assert enc.encode_batch(imgs, 500, 300, ColorType.RGB) == first
    assert enc.encode_batch(imgs[:2], 500, 300, ColorType.RGB) == first[:2]
    assert enc.encode_batch(imgs[1:], 500, 300, ColorType.RGB) == first[1:]
    assert pinned._buf.data_ptr() == buf.data_ptr()
    big = imgs * 4
    assert enc.encode_batch(big, 500, 300, ColorType.RGB) == first * 4
    assert pinned._buf.numel() > buf.numel()
    assert enc._pinned is pinned


@pytest.mark.parametrize("entry", ["encode", "progressive", "encode_batch"])
def test_files_outlive_the_next_encode_on_cuda(dev, entry):
    """The finish hands its scans over as views of the encoder's
    page-locked buffer, which every encode refills: each file comes back
    as bytes of its own, which the next encode leaves as it was, and
    equals the CPU path's file."""
    from tpuenc_torch import ColorType, Encoder

    calls = [_batch_images(2, 500, 300, seed=s) for s in (5, 6)]

    def run(device):
        enc = Encoder(90, device=device)
        enc.set_progressive(entry == "progressive")
        files, kept = [], []
        for imgs in calls:
            got = (enc.encode_batch(imgs, 500, 300, ColorType.RGB)
                   if entry == "encode_batch"
                   else [enc.encode(imgs[0], 500, 300, ColorType.RGB)])
            files += got
            kept += [bytes(bytearray(f)) for f in got]
        return enc, files, kept

    enc, files, kept = run(dev)
    assert enc.last_encode_path == ("device-batch" if entry == "encode_batch"
                                    else "device-v2")
    assert enc._pinned._buf.is_pinned()
    assert all(type(f) is bytes for f in files)
    assert files == kept == run("cpu")[1]


# ---------------------------------------------------------------------------
# The bounded-memory paths: chunks of a longer stream.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("si", range(len(SPECS)))
def test_k2_midstream_and_masked_pack_match_plain(dev, si):
    """K2 with a mid-stream DC chain (a nonzero tail, an offset that is
    not a multiple of the restart segment), and P1-P4 of the chunk with a
    masked tail (device_scan_pack), against the plain versions."""
    spec = SPECS[si]
    pat = len(spec.dc_tab_pattern)
    rng = np.random.default_rng(si)
    B = 5000 * pat
    q = (rng.laplace(0, 4, (64, B)) * (rng.random((64, B)) < 0.3)).astype(
        np.int16)
    q[0] = rng.integers(-500, 500, B)
    tail = torch.from_numpy(rng.integers(-500, 500, pat).astype(np.int32))
    go = 37 * pat
    out = {}
    for d in (dev, "cpu"):
        qs = torch.from_numpy(q).to(d)
        pd = _params(d)
        dcdiff = tpack.dc_diffs_from_dc(qs[0], spec, prev_tail=tail.to(d),
                                        global_offset=go)
        n = tpack.pack_blocks.launches
        p1 = tpack.scan_pack_blocks(qs, spec, pd.dc, pd.ac, 16, dcdiff=dcdiff)
        packed = tpack.device_scan_pack(qs, spec, pd.dc, pd.ac, 16,
                                        dcdiff=dcdiff, valid_blocks=B - 777)
        torch.cuda.synchronize()
        if d == dev:
            assert tpack.pack_blocks.launches == n + 2
        out[str(d)] = [t.cpu() for t in (dcdiff, *p1, *packed)]
    for got, want in zip(out[str(dev)], out["cpu"]):
        assert torch.equal(got, want)
    assert not out["cpu"][6][B - 777:].any()


def _chunked_encoder(device, sf="F_2_2", restart=0, opt=False):
    from tpuenc_torch import Encoder, SamplingFactor

    e = Encoder(90, device=device)
    e.set_sampling_factor(SamplingFactor[sf])
    e.set_restart_interval(restart)
    e.set_optimized_huffman_tables(opt)
    return e


@pytest.mark.parametrize("restart,opt", [(0, False), (7, False), (0, True)])
def test_chunked_encode_on_cuda_matches_cpu(dev, restart, opt, monkeypatch):
    """A chunked encode on the card (the block limit forced down, several
    chunks) equals the CPU path's bytes, and the whole-image path's."""
    from tpuenc_torch import ColorType
    from tpuenc_torch import plan as planning

    rng = np.random.default_rng(restart)
    w, h = 1000, 700
    px = rng.integers(0, 256, (h, w, 4), np.uint8)
    want = _chunked_encoder(dev, restart=restart, opt=opt).encode(
        px, w, h, ColorType.CMYK_AS_YCCK)
    monkeypatch.setattr(planning, "DEVICE_BLOCK_LIMIT", 1000)
    out = {}
    for d in (dev, "cpu"):
        e = _chunked_encoder(d, restart=restart, opt=opt)
        out[str(d)] = e.encode(px, w, h, ColorType.CMYK_AS_YCCK)
        assert e.last_encode_path == ("device-chunked-multipass" if opt
                                      else "device-chunked")
    assert out[str(dev)] == out["cpu"] == want
    pieces = list(_chunked_encoder(dev, restart=restart, opt=opt)
                  .encode_stream(px, w, h, ColorType.CMYK_AS_YCCK,
                                 chunk_mcu_rows=5))
    assert b"".join(pieces) == want


def test_chunked_finish_on_the_card(dev, monkeypatch):
    """A YCCK 4:2:0 encode with a restart interval on "device-chunked"
    (the block limit forced down, three chunks of 64 MCU rows): each chunk
    finished on the card, the file the CPU path's bytes, again from the
    encoder's reused page-locked pieces, and ``device_finished_chunks``
    its chunk count."""
    from tpuenc_torch import ColorType, tracing
    from tpuenc_torch import plan as planning

    rng = np.random.default_rng(23)
    w, h = 264, 2100  # 132 MCU rows of 16 pixels: chunks of 64, 64, 4
    px = rng.integers(0, 256, (h, w, 4), np.uint8)
    monkeypatch.setattr(planning, "DEVICE_BLOCK_LIMIT", 1000)
    want = _chunked_encoder("cpu", restart=7).encode(
        px, w, h, ColorType.CMYK_AS_YCCK)
    enc = _chunked_encoder(dev, restart=7)
    tracing.enable()
    try:
        got = enc.encode(px, w, h, ColorType.CMYK_AS_YCCK)
        (req,) = tracing.requests()
    finally:
        tracing.disable()
    assert enc.last_encode_path == "device-chunked"
    assert got == want
    assert req.counters["device_finished_chunks"] == 3
    assert req.counters["restart_segments"] == -(-(17 * 132) // 7)
    assert enc.encode(px, w, h, ColorType.CMYK_AS_YCCK) == want


def test_cuda_row_source(dev):
    """Row slabs that are already CUDA tensors give the host array's
    bytes; a slab on another device or short of rows raises."""
    from tpuenc_torch import BadImageData, ColorType

    rng = np.random.default_rng(5)
    w, h = 96, 88
    px = rng.integers(0, 256, (h, w, 3), np.uint8)
    dpx = torch.from_numpy(px).to(dev)
    enc = _chunked_encoder(dev, restart=2)
    want = b"".join(enc.encode_stream(px, w, h, ColorType.RGB,
                                      chunk_mcu_rows=3))
    got = b"".join(enc.encode_stream(lambda y0, n: dpx[y0:y0 + n], w, h,
                                     ColorType.RGB, chunk_mcu_rows=3))
    assert got == want
    with pytest.raises(ValueError):
        b"".join(enc.encode_stream(lambda y0, n: dpx[y0:y0 + n].cpu(), w, h,
                                   ColorType.RGB))
    with pytest.raises(BadImageData):
        b"".join(enc.encode_stream(lambda y0, n: dpx[y0:y0 + n - 1], w, h,
                                   ColorType.RGB))


def test_stuff_stream_raises_on_an_invalid_buffer(dev):
    """The native flush refuses a range outside its buffer, where
    tpuenc's binding returns None."""
    from tpuenc_torch.entropy import native

    with pytest.raises(ValueError):
        native.stuff_stream(bytes(64), 0, 65)
    assert native.stuff_stream(b"\xff" * 64, 0, 64) == b"\xff\x00" * 64


def _dirty_allocator(dev):
    """Leave the caching allocator's blocks, large and small, holding
    0xFF bytes, so that what the device finish allocates next starts
    dirty."""
    junk = [torch.full((256 << 20,), 0xFF, dtype=torch.uint8, device=dev)]
    junk += [torch.full((256 << 10,), 0xFF, dtype=torch.uint8, device=dev)
             for _ in range(64)]
    torch.cuda.synchronize()
    del junk


def _gradient(w, h, seed=42):
    """A flagship-like image: a smooth ramp per channel plus +-24 noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // w, yy * 255 // h,
                     (xx + yy) * 255 // (w + h)], axis=2)
    noise = rng.integers(-24, 24, base.shape)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _many_ff(w=48, h=48):
    px = np.zeros((h, w, 3), np.uint8)
    px[::2] = 255
    px[:, ::2, 1] = 255
    return px


DEVICE_FINISH = {
    # name: (image, quality, encoder settings)
    "flagship_split": (lambda: _gradient(2000, 1800), 90, {}),
    "flagship_fused": (lambda: _gradient(2000, 1800), 90, {"fused": True}),
    "flagship_progressive_optimized": (lambda: _gradient(2000, 1800), 90,
                                       {"scans": 4, "opt": True}),
    "uhd_420_restart64": (lambda: _gradient(3840, 2160), 80,
                          {"sf": "F_2_2", "restart": 64}),
    "many_ff": (_many_ff, 100, {"restart": 2}),
}


def _host_finish(buf, seg_bits, host_bits, segs, pinned=None):
    """The host finish in the device finish's place."""
    from tpuenc_torch.entropy import device_encode as de

    return de._finish_scans_v2(buf, host_bits, segs)


def _recorded_finish(monkeypatch):
    """Record every run of the device finish: its inputs, its scans and
    the peak device memory it added, with the allocator's blocks dirtied
    just before it."""
    from tpuenc_torch.entropy import device_encode as de

    seen = []
    finish = de._finish_scans_device

    def recorded(buf, seg_bits, host_bits, segs, pinned=None):
        _dirty_allocator(buf.device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        scans = finish(buf, seg_bits, host_bits, segs, pinned)
        peak = torch.cuda.max_memory_allocated() - base
        seen.append((buf, seg_bits, host_bits, segs, scans, peak))
        return scans

    monkeypatch.setattr(de, "_finish_scans_device", recorded)
    return seen, finish


@pytest.mark.parametrize("name", sorted(DEVICE_FINISH))
def test_device_finish_on_cuda(dev, name, monkeypatch):
    """The device finish on the card, its intermediates on a dirtied
    allocator: the file equals the host finish's, and the finish's scans
    equal the same finish run on the CPU over a copy of its stream."""
    from tpuenc_torch import ColorType, Encoder, SamplingFactor
    from tpuenc_torch.entropy import device_encode as de

    make, quality, kw = DEVICE_FINISH[name]
    px = make()
    h, w = px.shape[:2]

    def encoder():
        e = Encoder(quality, device=dev, fused_p1=kw.get("fused", False))
        if "sf" in kw:
            e.set_sampling_factor(SamplingFactor[kw["sf"]])
        e.set_restart_interval(kw.get("restart", 0))
        if kw.get("scans"):
            e.set_progressive_scans(kw["scans"])
        e.set_optimized_huffman_tables(kw.get("opt", False))
        return e

    with monkeypatch.context() as m:
        m.setattr(de, "_finish_scans_device", _host_finish)
        want = encoder().encode(px, w, h, ColorType.RGB)
    seen, finish = _recorded_finish(monkeypatch)
    enc = encoder()
    assert enc.encode(px, w, h, ColorType.RGB) == want
    assert enc.last_encode_path == ("device-v2-fused" if kw.get("fused")
                                    else "device-v2")
    ((buf, seg_bits, host_bits, segs, scans, _),) = seen
    assert buf.is_cuda
    assert finish(buf.cpu(), seg_bits.cpu(), host_bits, segs) == scans


def test_device_finish_memory_near_the_block_limit(dev, monkeypatch):
    """The largest whole-image encode: 13824x13824 RGB at q90, the
    flagship-like image tiled (2,989,441 blocks as the limit counts them),
    a scan of ~150 MB.  The device finish gives the host finish's scans,
    and adds at most its output (2 bytes per realigned byte and per
    segment) and a fixed set of window temporaries to the card's memory,
    whatever the stream's size."""
    from tpuenc_torch import ColorType, Encoder
    from tpuenc_torch import plan as planning
    from tpuenc_torch.entropy import device_encode as de
    from tpuenc_torch.entropy import device_stuff as ds

    w = h = 13824
    assert (w // 8 + 1) * (h // 8 + 1) <= planning.DEVICE_BLOCK_LIMIT
    px = np.ascontiguousarray(np.tile(_gradient(2000, 1800), (8, 7, 1))[:h, :w])
    seen, _ = _recorded_finish(monkeypatch)
    enc = Encoder(90, device=dev)
    enc.encode(px, w, h, ColorType.RGB)
    assert enc.last_encode_path == "device-v2"
    ((buf, _, host_bits, segs, scans, peak),) = seen
    seg_bits = host_bits.astype(np.int64)
    n1, S = int(((seg_bits + 7) >> 3).sum()), len(seg_bits)
    assert n1 > 100 << 20
    assert peak <= 2 * n1 + 2 * S + 16 * 8 * ds._WINDOW
    assert scans == de._finish_scans_v2(buf, host_bits, segs)


def test_all_ff_stream_on_cuda(dev):
    """An all-0xFF stream (twice the bytes out, past tpuenc's slack) on
    the card equals its CPU run and the native host finish."""
    from tpuenc_torch.entropy import native
    from tpuenc_torch.entropy.device_stuff import device_stuff

    structure = [7, 1, 12]
    bits = np.random.default_rng(3).integers(1, 20000, sum(structure))
    words = np.full((int(bits.sum()) + 31) >> 5, -1, np.int32)
    got = {}
    for d in (dev, "cpu"):
        if d == dev:
            _dirty_allocator(dev)
        out, seg_out, total = device_stuff(
            torch.from_numpy(words).to(d), torch.from_numpy(bits).to(d),
            structure, bits)
        got[str(d)] = (out[:int(total)].cpu().numpy().tobytes(),
                       seg_out.cpu().numpy().tolist())
    assert got[str(dev)] == got["cpu"]
    data = words.view(np.uint32).byteswap().tobytes()
    host, s = b"", 0
    for n in structure:
        host += native.realign_segments(data, bits[s:s + n],
                                        bit_offset=int(bits[:s].sum()))
        s += n
    assert got["cpu"][0] == host


# ---------------------------------------------------------------------------
# The pixel upload: staged through one page-locked buffer a device.
# ---------------------------------------------------------------------------

@pytest.fixture
def small_buffer(monkeypatch):
    """A page-locked buffer of 1,000,000 bytes, so that a small image's
    uploads start again at its head every two or three, and a larger
    array grows it: the test's uploads go through stagers of their own,
    and the process's are back after it."""
    from tpuenc_torch import upload

    monkeypatch.setattr(upload, "BUFFER_BYTES", 1_000_000)
    monkeypatch.setattr(upload, "_stagers", {})
    return 1_000_000


def _traced(fn):
    from tpuenc_torch import tracing

    tracing.enable()
    try:
        out = fn()
        reqs = tracing.requests()
    finally:
        tracing.disable()
    return out, reqs


def test_staged_upload_equals_to(dev):
    """At the real buffer size, an array larger than the buffer (which
    grows it), a read-only one, a strided one and an empty one arrive as
    ``.to()`` brings them; into a batch slot too; the caller may overwrite
    the array as soon as the upload returns."""
    from tpuenc_torch import upload

    rng = np.random.default_rng(31)
    size = upload.BUFFER_BYTES + 12_345
    px = rng.integers(0, 256, (size // 3, 3), np.uint8)
    want = torch.from_numpy(px).to(dev)
    stager = upload.StagedUpload(dev)
    got = stager.upload(px)
    px[:] = 0  # the host read is over when upload returns
    assert torch.equal(got, want)
    ro = want.cpu().numpy()
    ro.flags.writeable = False
    assert torch.equal(stager.upload(ro), want)
    assert torch.equal(stager.upload(ro[:, ::2]), want[:, ::2])
    assert stager.upload(ro[:0]).shape == (0, 3)
    slots = torch.zeros((2, *ro.shape), dtype=torch.uint8, device=dev)
    stager.upload_into(slots[1], ro)
    assert torch.equal(slots[1], want) and not slots[0].any()
    with pytest.raises(ValueError):
        stager.upload_into(slots[0][:-1], ro)


def test_staged_upload_behind_queued_work(dev, small_buffer):
    """Uploads queued behind long work on another current stream, into
    memory just freed there, and back to back through one buffer: each
    arrives whole, and each returns with its host array free."""
    from tpuenc_torch import upload

    rng = np.random.default_rng(32)
    arrays = [rng.integers(0, 256, 1_234_567, np.uint8) for _ in range(4)]
    stager = upload.StagedUpload(dev)
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        got = []
        for a in arrays:
            busy = torch.full((1_234_567,), 7, dtype=torch.uint8, device=dev)
            torch.cuda._sleep(5_000_000)
            busy.add_(1)
            del busy  # freed on ``side`` with its work still queued
            kept = a.copy()
            got.append((stager.upload(a), kept))
            a[:] = 0
    for t, k in got:
        assert np.array_equal(t.cpu().numpy(), k)


def test_staged_memory_outlives_its_readers(dev, small_buffer):
    """A staged tensor freed while work queued on the current stream has
    yet to read it: the next uploads, whose copies wait for no compute
    work, do not write over its memory before that work has read it."""
    from tpuenc_torch import upload

    rng = np.random.default_rng(33)
    arrays = [rng.integers(0, 256, 1_234_567, np.uint8) for _ in range(6)]
    reads = []
    for a in arrays:
        t = upload.to_device(a, dev)
        torch.cuda._sleep(5_000_000)  # the current stream falls behind
        reads.append(t.clone())
        del t  # freed with the clone still queued
    for r, a in zip(reads, arrays):
        assert np.array_equal(r.cpu().numpy(), a)


ROUTE_CASES = {
    # name: (encoder settings, the image's shape, a batch of n, the chunked
    # routes' block limit, last_encode_path)
    "whole_image": ({}, (300, 500, 3), 0, None, "device-v2"),
    "fused": ({"fused": True}, (300, 500, 3), 0, None, "device-v2-fused"),
    "progressive_optimized": ({"scans": 4, "opt": True}, (300, 500, 3), 0,
                              None, "device-v2"),
    "batch_single": ({}, (300, 500, 3), 3, None, "device-batch"),
    "batch_per_image": ({"restart": 11}, (300, 500, 3), 3, None,
                        "device-batch-per-image"),
    "chunked": ({"restart": 7}, (2100, 264, 4), 0, 1000, "device-chunked"),
    "chunked_multipass": ({"opt": True}, (2100, 264, 4), 0, 1000,
                          "device-chunked-multipass"),
}


def _route_call(name, device):
    """(the encoder, a function that encodes the case's pixels with it)."""
    from tpuenc_torch import ColorType

    kw, shape, n, _, _ = ROUTE_CASES[name]
    h, w, c = shape
    ct = ColorType.RGB if c == 3 else ColorType.CMYK_AS_YCCK
    enc = _batch_encoder(device, 90, kw)
    if c == 4:
        enc = _chunked_encoder(device, restart=kw.get("restart", 0),
                               opt=kw.get("opt", False))
    if n:
        return enc, lambda imgs: enc.encode_batch(imgs, w, h, ct)
    return enc, lambda imgs: [enc.encode(imgs[0], w, h, ct)]


@pytest.mark.parametrize("name", sorted(ROUTE_CASES))
def test_routes_stage_their_pixels(dev, small_buffer, name, monkeypatch):
    """Each route on the card: the files equal the CPU path's (which
    stages nothing), ``upload_slabs`` counts each pixel upload (an image
    or a chunk), the caller's arrays may be overwritten as soon as the
    call returns, and the device's buffer is reused by the next call."""
    from tpuenc_torch import upload
    from tpuenc_torch import plan as planning

    kw, shape, n, limit, path = ROUTE_CASES[name]
    if limit is not None:
        monkeypatch.setattr(planning, "DEVICE_BLOCK_LIMIT", limit)
    rng = np.random.default_rng(len(name))
    imgs = [rng.integers(0, 256, shape, np.uint8) for _ in range(n or 1)]
    want = _route_call(name, "cpu")[1]([im.copy() for im in imgs])
    enc, call = _route_call(name, dev)
    got, (req,) = _traced(lambda: call(imgs))
    for im in imgs:
        im[:] = 0  # overwritten as soon as the call returns
    assert enc.last_encode_path == path
    assert got == want
    # an image each, or a chunk of 64 MCU rows of 16 pixel rows each
    staged = len(imgs) if limit is None else -(-shape[0] // 1024)
    assert req.counters["upload_slabs"] == staged
    buffer = upload.stager(dev)._buffer.data_ptr()
    others = [rng.integers(0, 256, shape, np.uint8) for _ in imgs]
    want = _route_call(name, "cpu")[1]([im.copy() for im in others])
    assert call(others) == want
    assert upload.stager(dev)._buffer.data_ptr() == buffer


def test_two_encoders_alternate_on_one_buffer(dev, small_buffer):
    """Two encoders' calls interleaved, and back-to-back calls on one,
    each give the CPU path's file: both stage through the device's one
    buffer, which is page-locked and stays the same."""
    from tpuenc_torch import ColorType, upload

    rng = np.random.default_rng(41)
    imgs = [rng.integers(0, 256, (300, 500, 3), np.uint8) for _ in range(4)]
    cpu = _batch_encoder("cpu", 90, {})
    want = [cpu.encode(im, 500, 300, ColorType.RGB) for im in imgs]
    a, b = _batch_encoder(dev, 90, {}), _batch_encoder(dev, 90, {})
    got = []
    for i, im in enumerate(imgs * 2):
        got.append((a if i % 3 else b).encode(im, 500, 300, ColorType.RGB))
    assert got == want * 2
    stager = upload.stager(dev)
    assert upload.stager(torch.device(dev)) is stager
    assert len(upload._stagers) == 1
    assert stager._buffer.is_pinned()
    assert stager._buffer.numel() == small_buffer


def test_row_source_may_reuse_its_buffer(dev, small_buffer):
    """A pull source that refills one host buffer for every chunk: each
    upload has read it before the next pull, so the stream's file is
    ``encode``'s."""
    from tpuenc_torch import ColorType

    rng = np.random.default_rng(43)
    w, h = 200, 120
    px = rng.integers(0, 256, (h, w, 3), np.uint8)
    want = _chunked_encoder("cpu", restart=3).encode(px, w, h, ColorType.RGB)
    buf = np.empty((h, w, 3), np.uint8)

    def rows(y0, n):
        buf[:n] = px[y0:y0 + n]
        buf[n:] = 0
        return buf[:n]

    enc = _chunked_encoder(dev, restart=3)
    got, (req,) = _traced(lambda: b"".join(enc.encode_stream(
        rows, w, h, ColorType.RGB, chunk_mcu_rows=2)))
    assert got == want
    assert req.counters["upload_slabs"] == -(-h // 32)  # one a chunk


# The striped encode (tpuenc_torch.shard) over 2 gloo ranks, each
# computing on cuda:0: an interleaved case and an optimized one.
SHARD_CASES = [
    dict(name="interleaved", kind="encode", quality=85, settings=[], w=256,
         h=512, color_type="RGB", seeds=[0]),
    dict(name="optimized", kind="encode", quality=85,
         settings=[("set_optimized_huffman_tables", True)], w=256, h=512,
         color_type="RGB", seeds=[1]),
]


@pytest.fixture(scope="module")
def shard_ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from tpuenc_torch.testing.dist import launch
    from tpuenc_torch.testing.shard_cases import run_cases

    return launch(run_cases, 2, (1, SHARD_CASES, "cuda:0"), cuda_device=0,
                  timeout=300)


@pytest.mark.parametrize("case", SHARD_CASES, ids=lambda c: c["name"])
def test_sharded_encode_on_cuda(dev, shard_ranks, case):
    """Each rank's file equals ``Encoder(device="cuda")``'s; each rank
    launched K1, K2, K3 and K5 (and K7 with optimized tables), and
    neither K6 nor K8."""
    from tpuenc_torch import ColorType, Encoder
    from tpuenc_torch.testing.shard_cases import apply_settings, case_images

    enc = Encoder(case["quality"], device=dev)
    apply_settings(enc, case["settings"])
    (image,) = case_images(case)
    want = enc.encode(image, case["w"], case["h"], ColorType.RGB)
    optimized = bool(case["settings"])
    for result in shard_ranks:
        (got,), path, _, launches = result[case["name"]]
        assert got == want and path == "sharded-general"
        for k in ("fdct_quantize", "pack_blocks", "merge_chunks",
                  "concat_rows"):
            assert launches[k] > 0, k
        assert (launches["hist_count"] > 0) == optimized
        assert launches["pack_acbands"] == 0
        assert launches["fused_sample_pack"] == 0


# ShardedEncoder's inherited entry points over a one-rank NCCL mesh.
NCCL_ENTRY = dict(name="entry", kind="entry", quality=90, settings=[],
                  w=256, h=512, color_type="RGB", seeds=[2])


def test_sharded_entry_points_on_nccl(dev):
    """``encode_image`` and ``encode_stream`` of a ``ShardedEncoder`` on a
    one-rank NCCL mesh on cuda:0 equal ``Encoder(device="cuda")``'s bytes,
    on ``Encoder``'s routes."""
    from tpuenc_torch import ColorType, Encoder
    from tpuenc_torch.testing.dist import launch
    from tpuenc_torch.testing.shard_cases import (
        case_images,
        planes_buffer,
        run_cases,
    )

    (got,) = launch(run_cases, 1, (1, [NCCL_ENTRY], "cuda:0", "cuda"),
                    backend="nccl", cuda_device=0, timeout=300)
    (image,) = case_images(NCCL_ENTRY)
    w, h = NCCL_ENTRY["w"], NCCL_ENTRY["h"]
    enc = Encoder(90, device=dev)
    want = {"encode_image": (enc.encode_image(planes_buffer(image)),
                             "device-v2"),
            "encode_stream": (b"".join(enc.encode_stream(image, w, h,
                                                         ColorType.RGB)),
                              "device-chunked-stream")}
    assert got["entry"] == want
