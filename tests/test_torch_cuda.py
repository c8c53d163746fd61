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
