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
]


def _blocks(B, seed):
    rng = np.random.default_rng(seed)
    q = np.zeros((64, B), np.int16)
    mask = rng.random((64, B)) < 0.2
    q[mask] = rng.integers(-300, 300, (64, B))[mask]
    q[0] = rng.integers(-1000, 1000, B)
    q[1:40, 1::7] = 0
    q[:, 3::11] = rng.integers(-60, 60, (64, q[:, 3::11].shape[1]))
    q[:, 10:14] = rng.integers(-900, 900, (64, 4))  # overflow rung 16
    return q


@pytest.mark.parametrize("si", range(len(SPECS)))
@pytest.mark.parametrize("budget", [16, 48])
def test_k2_matches_plain(dev, si, budget):
    spec = SPECS[si]
    p = _params(dev)
    q = torch.from_numpy(_blocks(1000, si)).to(dev)
    dcdiff = tpack.dc_diffs_from_dc(q[0], spec)
    n = tpack.pack_blocks.launches
    got = tpack.pack_blocks(q, dcdiff, p.dc, p.ac, spec, 1024, budget)
    torch.cuda.synchronize()
    want = tpack.pack_blocks_ref(q, dcdiff, p.dc, p.ac, spec, 1024, budget)
    assert tpack.pack_blocks.launches == n + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if si == 0:
        assert bool(got[2].item()) == (budget == 16)


def _strings(Bp, capB, seed, mean_bits):
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.poisson(mean_bits, Bp), 32 * capB).astype(np.int32)
    lens[rng.random(Bp) < 0.1] = 0
    words = rng.integers(0, 1 << 32, (Bp, capB), dtype=np.uint64)
    full = np.clip(lens[:, None] - np.arange(capB)[None, :] * 32, 0, 32)
    keep = np.where(full >= 32, 0xFFFFFFFF, ((1 << full) - 1) << (32 - full))
    words = (words & keep.astype(np.uint64)).astype(np.uint32).view(np.int32)
    return words, lens


@pytest.mark.parametrize("run,n_runs,budget,mean_bits", [
    (8, 16 * 5, 16, 150),
    (256, 128, 5, 130),     # the flagship's P2 shape at rung 5
    (6, 128, 5, 590),       # a P3-like fold that overflows
])
def test_k3_k4_match_plain(dev, run, n_runs, budget, mean_bits):
    capB = tpack.final_block_cap(max(budget, 16))
    words, lens = _strings(run * n_runs - 37, capB, run, mean_bits)
    w = torch.from_numpy(words).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    caps = tpack.chunk_caps(capB, 1 << (run - 1).bit_length(), budget)
    want = tpack.merge_rows_ref(w, ln, run, n_runs, caps, caps[-1])
    for fn in (tpack.merge_chunks, tpack.fold_rows):
        n = fn.launches
        got = fn(w, ln, run, n_runs, caps, caps[-1])
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


ACBANDS = [
    ((1, 22), (22, 43), (43, 64)),            # the flagship's 4-scan plan
    ((1, 6), (6, 11), (11, 16), (16, 21)),    # four bands of a 13-scan plan
    ((1, 64),),                               # one band over every AC slot
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
