"""tpuenc_torch P1-P4 (K2-K5) against tpuenc's Pallas kernels in interpret
mode, on the CPU, bit for bit (tolerance 0).

The port's wrappers run the kernels' plain PyTorch versions on CPU
tensors.  Bit words are compared as int32 bit patterns
(``np.asarray(x).view(np.int32)`` on the JAX side).  Where a stage
overflows, its words are discarded by the budget ladder on both sides, so
only the flag and the lengths are compared.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpuenc.core.tables import default_tables  # noqa: E402
from tpuenc.entropy import pallas_pack as jpack  # noqa: E402
from tpuenc.entropy.device_encode import _dc_prev_delta  # noqa: E402
from tpuenc.entropy.device_encode import tables_to_arrays  # noqa: E402
from tpuenc.entropy.device_pack import ScanSpec  # noqa: E402
from tpuenc_torch.core.tables import quantization_table as tquant  # noqa: E402
from tpuenc_torch.entropy import native as tnative  # noqa: E402
from tpuenc_torch.entropy import pallas_pack as tpack  # noqa: E402
from tpuenc_torch.entropy.device_encode import params_from_numpy  # noqa: E402
from tpuenc_torch.entropy.device_pack import ScanSpec as TScanSpec  # noqa: E402

HUFFMAN = [list(p) for p in default_tables()]
ARRAYS = tables_to_arrays(HUFFMAN)
JDC, JAC = jpack.pack_tables(ARRAYS)


def _tparams():
    q = [tquant("default", 90, True), tquant("default", 90, False)]
    return params_from_numpy(q, *ARRAYS, "cpu")


def _spec(pattern, tabs, seg, ss=1, se=64, emit_dc=True):
    dc = tuple(tabs[c] for c in pattern)
    return ScanSpec(ss, se, emit_dc, True, dc, dc, _dc_prev_delta(pattern), seg)


SPECS = {
    "rgb444": _spec((0, 1, 2), (0, 1, 1), 0),
    "rgb420": _spec((0, 0, 0, 0, 1, 2), (0, 0, 0, 0, 1, 1), 0),
    "rgb420_rst2": _spec((0, 0, 0, 0, 1, 2), (0, 0, 0, 0, 1, 1), 12),
    "cmyk": _spec((0, 1, 2, 3), (1, 1, 1, 0), 0),
    "luma_rst5": _spec((0,), (0,), 5),
    "prog_band": _spec((0,), (1,), 0, ss=6, se=40, emit_dc=False),
}


def _blocks(B, seed, density=0.2, amp=300):
    """Coefficient-major (64, B) int16 blocks: sparse blocks with long
    zero runs (ZRL), a few dense high-magnitude ones, all-zero ones."""
    rng = np.random.default_rng(seed)
    q = np.zeros((64, B), np.int16)
    mask = rng.random((64, B)) < density
    q[mask] = rng.integers(-amp, amp, (64, B))[mask]
    q[0] = rng.integers(-1000, 1000, B)
    q[1:40, 1::7] = 0                        # runs of >= 16 zeros
    q[45, 1::7] = rng.integers(1, 50, q[45, 1::7].shape)
    q[:, 3::11] = rng.integers(-60, 60, (64, q[:, 3::11].shape[1]))  # dense
    q[1:, 5::13] = 0                         # DC-only blocks (EOB at slot 1)
    return q


def _jax_p1(q, spec, budget, tile=32):
    w, l, o = jpack.scan_pack_blocks(jnp.asarray(q), spec, JDC, JAC, budget,
                                     tile=tile, interpret=True, cm=True)
    return np.asarray(w).view(np.int32), np.asarray(l), bool(o)


def _torch_p1(q, spec, budget, tile=32):
    p = _tparams()
    w, l, o = tpack.scan_pack_blocks(torch.from_numpy(q), TScanSpec(*spec),
                                     p.dc, p.ac, budget, tile=tile)
    return w.numpy(), l.numpy(), bool(o.item())


@pytest.mark.parametrize("name", sorted(SPECS))
def test_p1_matches_pallas(name):
    """K2 plain version == scan_pack_blocks(interpret, cm, tile=32):
    words, lengths and the overflow flag, for each table pattern, a
    restart interval and a progressive band."""
    q = _blocks(203, len(name))
    spec = SPECS[name]
    jw, jl, jo = _jax_p1(q, spec, 16)
    tw, tl, to = _torch_p1(q, spec, 16)
    assert tw.shape == jw.shape and tl.shape == jl.shape
    assert to == jo
    np.testing.assert_array_equal(tl, jl)
    if not jo:
        np.testing.assert_array_equal(tw, jw)
    assert (tw[:, 0] < 0).any(), "no code with the top bit set"


@pytest.mark.parametrize("budget", [16, 48])
def test_p1_overflow_flag(budget):
    """Dense high-magnitude blocks overflow the rung-16 block caps
    (8-slot window) but not rung 48's: the flag matches either way."""
    q = _blocks(70, 5)
    q[:, 10:14] = np.random.default_rng(1).integers(-900, 900, (64, 4))
    spec = SPECS["rgb444"]
    jw, jl, jo = _jax_p1(q, spec, budget)
    tw, tl, to = _torch_p1(q, spec, budget)
    assert jo == (budget == 16)
    assert to == jo
    np.testing.assert_array_equal(tl, jl)
    if not jo:
        np.testing.assert_array_equal(tw, jw)


def test_p1_q100_dense():
    """Dense q100-like content (every slot nonzero) packs at rung 48."""
    rng = np.random.default_rng(9)
    q = rng.integers(-40, 40, (64, 64)).astype(np.int16)
    q[q == 0] = 1
    jw, jl, jo = _jax_p1(q, SPECS["luma_rst5"], 48)
    tw, tl, to = _torch_p1(q, SPECS["luma_rst5"], 48)
    assert not jo and not to
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tw, jw)


def test_dc_diffs_match():
    """DC predictor with a restart interval and a per-block component
    pattern (_dc_prev_delta)."""
    dc = np.random.default_rng(2).integers(-500, 500, 97).astype(np.int16)
    for name in ("rgb420_rst2", "cmyk", "luma_rst5"):
        spec = SPECS[name]
        want = np.asarray(jpack.dc_diffs_from_dc(jnp.asarray(dc), spec))
        got = tpack.dc_diffs_from_dc(torch.from_numpy(dc), TScanSpec(*spec))
        np.testing.assert_array_equal(got.numpy(), want)


def _strings(Bp, capB, rng, mean_bits):
    """Synthetic per-block bit strings: random bits, zero past the length."""
    lens = np.minimum(rng.poisson(mean_bits, Bp), 32 * capB).astype(np.int32)
    lens[rng.random(Bp) < 0.1] = 0
    words = rng.integers(0, 1 << 32, (Bp, capB), dtype=np.uint64)
    bit = np.arange(capB)[None, :] * 32
    full = np.clip(lens[:, None] - bit, 0, 32)
    keep = np.where(full >= 32, 0xFFFFFFFF,
                    ((1 << full) - 1) << (32 - full)).astype(np.uint64)
    words = (words & keep).astype(np.uint32)
    return words, lens


@pytest.mark.parametrize("Bp,budget,mean_bits,p3,ovf", [
    (96, 16, 150, False, False),    # n2 = 1: P2 then P4
    (608, 16, 150, True, False),    # n2 = 5: P2, P3 fold, P4
    (608, 5, 590, True, True),      # rung 5: the fold caps overflow
    (608, 5, 60, True, False),      # rung 5 that fits
])
def test_merge_matches_pallas(Bp, budget, mean_bits, p3, ovf):
    """K3/K4/K5 plain versions == merge_pack_stream(n_sub=16, chunk=8,
    interpret): stream, total bits and overflow flag, on the branch with
    the P3 fold and the one without."""
    rng = np.random.default_rng(Bp + budget + mean_bits)
    capB = tpack.final_block_cap(max(budget, 16))
    words, lens = _strings(Bp, capB, rng, mean_bits)
    js, jbits, jo = jpack.merge_pack_stream(
        jnp.asarray(words), jnp.asarray(lens), budget, n_sub=16, chunk=8,
        interpret=True,
    )
    calls = tpack.fold_rows.launches
    ts, tbits, to = tpack.merge_pack_stream(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(lens),
        budget, n_sub=16, chunk=8,
    )
    assert tpack.fold_rows.launches == calls  # CPU: plain versions only
    assert bool(to.item()) == bool(jo) == ovf
    assert int(tbits) == int(jbits) == int(lens.sum())
    js = np.asarray(js).view(np.int32)
    assert ts.shape == js.shape
    if not bool(jo):
        np.testing.assert_array_equal(ts.numpy(), js)
    n1 = -(-Bp // 16)
    assert (-(-n1 // 8) > 1) == p3



# name: (R, W, mean bits per row, extra capW words, options).  The TPU
# kernel takes R in multiples of 8 and capW of at least R * W + W + 256
# rounded up to 128; options: empty = rows set empty, full = rows that
# fill all W words, mult32 = lengths rounded down to multiples of 32.
CONCATS = {
    "one_nonempty_row": (8, 40, 900, 0, {"empty": slice(1, 8)}),
    "empty_middle_and_end": (64, 20, 200, 0,
                             {"empty": [*range(20, 30), *range(56, 64)]}),
    "multiples_of_32": (32, 16, 250, 0, {"mult32": True}),
    "full_rows": (16, 12, 200, 0, {"full": [0, 7, 15]}),
    "tail_far_past_data": (16, 8, 100, 4096, {}),
}


@pytest.mark.parametrize("case", sorted(CONCATS))
def test_concat_rows_matches_pallas(case):
    """K5's plain version == tpuenc's K5 in interpret mode on the edge
    shapes its CUDA kernel is held to on the card."""
    R, W, mean_bits, extra, opt = CONCATS[case]
    rng = np.random.default_rng(R + W)
    words, bits = _strings(R, W, rng, mean_bits)
    if "empty" in opt:
        bits[opt["empty"]] = 0
    if opt.get("mult32"):
        bits = bits // 32 * 32
    for r in opt.get("full", []):
        bits[r] = 32 * W
    full = np.clip(bits[:, None] - np.arange(W)[None, :] * 32, 0, 32)
    keep = np.where(full >= 32, 0xFFFFFFFF,
                    ((1 << full) - 1) << (32 - full)).astype(np.uint64)
    words = (words.astype(np.uint64) & keep).astype(np.uint32)
    bits = bits.astype(np.int32)
    capW = -(-(R * W + W + 256) // 128) * 128 + extra
    pos = np.concatenate([[0], np.cumsum(bits)[:-1]]).astype(np.int32)
    want = jpack._build_concat_rows_fn(R, W, capW, True)(
        jnp.asarray(pos), jnp.asarray(bits), jnp.asarray(words))
    got = tpack.concat_rows(torch.from_numpy(words.view(np.int32)),
                            torch.from_numpy(pos.astype(np.int64)),
                            torch.from_numpy(bits), capW)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want)[0].view(np.int32))

def _serial_stream(words, lens):
    acc, n = 0, 0
    for w, nb in zip(words, lens):
        row = int.from_bytes(w.astype(">u4").tobytes(), "big")
        acc = (acc << int(nb)) | (row >> (32 * len(w) - int(nb)))
        n += int(nb)
    return acc, n


def _stream_int(stream, nbits):
    nw = (nbits + 31) // 32
    v = int.from_bytes(stream[:nw].view(np.uint32).astype(">u4").tobytes(), "big")
    return v >> (32 * nw - nbits)


def test_merge_without_fold_plan(monkeypatch):
    """With several chunks per substream but no P3 plan (TPU VMEM budget
    exceeded), P4 concatenates every chunk row: the stream is still the
    serial concatenation of the blocks."""
    rng = np.random.default_rng(4)
    words, lens = _strings(608, 19, rng, 90)
    monkeypatch.setattr(tpack, "fold_plan", lambda *a, **k: None)
    ts, tbits, to = tpack.merge_pack_stream(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(lens), 16,
        n_sub=16, chunk=8,
    )
    want, n = _serial_stream(words, lens)
    assert not bool(to.item()) and int(tbits) == n
    assert _stream_int(ts.numpy(), n) == want


def test_cap_schedules_match():
    for b in (4, 5, 6, 8, 12, 14, 16, 48, 224):
        assert tpack.block_caps(b) == jpack.block_caps(b)
        assert tpack.chunk_caps(19, 256, b) == jpack.chunk_caps(19, 256, b)
        assert tpack.fold_caps(1536, 8, b * 256) == jpack.fold_caps(1536, 8, b * 256)
    for args in [(8, 256, 16, 512), (16, 4096, 16, 8192),
                 (8, 131200, 128, 131072), (8, 1536, 128, 1280)]:
        assert tpack.fold_plan(*args) == jpack.fold_plan(*args)


def test_params_match_packed_tables():
    p = _tparams()
    np.testing.assert_array_equal(p.dc.numpy(), np.asarray(JDC))
    np.testing.assert_array_equal(p.ac.numpy(), np.asarray(JAC))


@pytest.mark.parametrize("segs,offset", [([13, 0, 77, 5], 0), ([64, 9], 3)])
def test_native_realign_matches_oracle(segs, offset):
    rng = np.random.default_rng(sum(segs))
    data = bytes(rng.integers(0, 256, 64, np.uint8)) + b"\xff" * 8
    got = tnative.realign_segments(data, segs, bit_offset=offset)
    assert got == tnative.realign_segments_py(data, segs, bit_offset=offset)


def test_copied_tables_match():
    """The copied table module: quantization presets at every quality
    step, the K.3 defaults, and the K.2 build from random histograms."""
    from tpuenc.core import tables as jt
    from tpuenc_torch.core import tables as tt

    for name in jt.QUANT_PRESET_NAMES:
        for q in (1, 37, 90, 100):
            for luma in (True, False):
                a = jt.quantization_table(name, q, luma)
                b = tt.quantization_table(name, q, luma)
                for f in ("values", "reciprocals", "corrections"):
                    np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    rng = np.random.default_rng(0)
    for _ in range(5):
        freq = np.zeros(257, np.int64)
        freq[:256] = rng.integers(0, 1000, 256) * (rng.random(256) < 0.5)
        freq[256] = 1
        a, b = jt.optimized_huffman_table(freq), tt.optimized_huffman_table(freq)
        np.testing.assert_array_equal(a.sizes, b.sizes)
        np.testing.assert_array_equal(a.codes, b.codes)
