"""tpuenc_torch's two-pass statistics (K7, K9, the device histograms, the
K.2 build and the exact stream size) against tpuenc on the CPU, exactly.

The port's wrappers run the kernels' plain PyTorch versions on CPU
tensors; the JAX side runs its Pallas kernels in interpret mode.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpuenc.core import tables as jtables  # noqa: E402
from tpuenc.entropy import device as jdevice  # noqa: E402
from tpuenc.entropy import huffopt as jhuffopt  # noqa: E402
from tpuenc.entropy import native as jnative  # noqa: E402
from tpuenc.entropy import pallas_hist as jhist  # noqa: E402
from tpuenc_torch.core import tables as ttables  # noqa: E402
from tpuenc_torch.core.types import (  # noqa: E402
    ColorType,
    EncoderConfig,
    JpegColorType,
    SamplingFactor,
    init_components,
)
from tpuenc_torch.entropy import device as tdevice  # noqa: E402
from tpuenc_torch.entropy import device_encode as tde  # noqa: E402
from tpuenc_torch.entropy import huffopt as thuffopt  # noqa: E402
from tpuenc_torch.entropy import native as tnative  # noqa: E402
from tpuenc_torch.entropy import pallas_hist as thist  # noqa: E402
from tpuenc_torch.kernels import pipeline as tpipe  # noqa: E402


def _stream(B, seed):
    """Coefficient-major (64, B) int16 stream: sparse coefficients, runs of
    16 and more zeros, all-zero bands, a few dense blocks."""
    rng = np.random.default_rng(seed)
    q = np.zeros((64, B), np.int16)
    mask = rng.random((64, B)) < 0.15
    q[mask] = rng.integers(-200, 200, (64, B))[mask]
    q[0] = rng.integers(-1000, 1000, B)
    q[1:40, 2::9] = 0
    q[50, 2::9] = 3
    q[1:, 4::11] = 0
    q[:, 7::23] = rng.integers(-900, 900, (64, q[:, 7::23].shape[1]))
    return q


BAND_SETS = {
    1: [(1, 64)],
    2: jhuffopt.progressive_bands(3),
    3: jhuffopt.progressive_bands(4),
    5: jhuffopt.progressive_bands(13)[3:8],
    8: jhuffopt.progressive_bands(9),
    "8_empty": jhuffopt.progressive_bands(34)[:8],   # (1, 1) among them
}


@pytest.mark.parametrize("name", list(BAND_SETS), ids=str)
def test_k7_matches_pallas(name):
    """K7's plain version == _hist_count_kernel (interpret): the raw
    per-band counts, and the 257-bin histograms of
    ac_histograms_pallas_multiband, empty bands included."""
    bands = tuple(BAND_SETS[name])
    q = _stream(400, len(bands))
    want = [np.asarray(h) for h in jhist.ac_histograms_pallas_multiband(
        jnp.asarray(q), bands, interpret=True)]
    got = thist.ac_histograms_multiband(torch.from_numpy(q), bands)
    assert len(got) == len(want) == len(bands)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    live = tuple(b for b in bands if b[0] < b[1])
    raw = np.asarray(jhist._build_count_fn(400, live, True)(jnp.asarray(q)))
    raw = raw.reshape(len(live), 24, 128)
    mine = thist.hist_count_ref(torch.from_numpy(q), live).numpy()
    np.testing.assert_array_equal(mine[:, :272].reshape(-1, 16, 17),
                                  raw[:, :16, :17])
    np.testing.assert_array_equal(mine[:, 272], raw[:, 16, 0])
    np.testing.assert_array_equal(mine[:, 273], raw[:, 17, 0])


@pytest.mark.parametrize("band", [(1, 64), (6, 40), (22, 43), (63, 64)])
def test_k9_matches_pallas(band):
    """K9's plain version == _build_sym_fn's outputs (interpret): run4 and
    size streams, the per-block ZRL and EOB partials; and the one-hot count
    after it == ac_histogram_pallas."""
    ss, se = band
    B = 600
    q = _stream(B, ss)
    run4, size, parts = (np.asarray(a) for a in
                         jhist._build_sym_fn(B, ss, se, True)(jnp.asarray(q)))
    Lp = run4.shape[1]
    t_run4, t_size, t_parts = thist.hist_sym_ref(torch.from_numpy(q), ss, se,
                                                 Lp)
    np.testing.assert_array_equal(t_run4.numpy(), run4)
    np.testing.assert_array_equal(t_size.numpy(), size)
    parts = parts.reshape(-1, 8, parts.shape[1])
    np.testing.assert_array_equal(t_parts[0].numpy(), parts[:, 0].reshape(-1))
    np.testing.assert_array_equal(t_parts[1].numpy(), parts[:, 1].reshape(-1))
    want = np.asarray(jhist.ac_histogram_pallas(jnp.asarray(q), ss, se,
                                                interpret=True))
    np.testing.assert_array_equal(
        thist.ac_histogram_sym(torch.from_numpy(q), ss, se).numpy(), want)


@pytest.mark.parametrize("bands", [((1, 22), (21, 43)),
                                   ((1, 22), (22, 43), (1, 22)),
                                   ((5, 10), (1, 64))], ids=str)
def test_k7_rejects_overlapping_bands(bands):
    """K7 walks a block's slots once for all its bands, so a slot belongs
    to one band only: its wrapper raises on CPU tensors too."""
    with pytest.raises(ValueError):
        thist.hist_count(torch.from_numpy(_stream(40, 1)), bands)


@pytest.mark.parametrize("order", [(2, 0, 1), (3, 2, 1, 0)], ids=str)
def test_k7_band_order(order):
    """Bands given out of slot order: row i of the counts is band i, the
    sorted order's rows permuted."""
    bands = ((1, 6), (6, 22), (22, 40), (40, 64))[:len(order)]
    q = torch.from_numpy(_stream(300, 8))
    raw = thist.hist_count(q, bands)
    got = thist.hist_count(q, tuple(bands[i] for i in order))
    assert torch.equal(got, raw[list(order)])


@pytest.mark.parametrize("band", [(1, 64), (1, 1), (30, 41)])
def test_plain_ac_histogram_matches(band):
    """device.ac_histogram (plain PyTorch) == tpuenc's XLA formulation and
    the K7 route."""
    q = _stream(333, band[1])
    want = np.asarray(jdevice.ac_histogram(jnp.asarray(q), *band, cm=True))
    got = tdevice.ac_histogram(torch.from_numpy(q), *band)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        thist.ac_histograms_multiband(torch.from_numpy(q), [band])[0].numpy(),
        want)


MODES = {
    "rgb_prog4": (JpegColorType.YCBCR, SamplingFactor.F_1_1, 4),
    "rgb_prog13_420": (JpegColorType.YCBCR, SamplingFactor.F_2_2, 13),
    "rgb_seq": (JpegColorType.YCBCR, SamplingFactor.F_1_1, None),
    "luma_prog3": (JpegColorType.LUMA, SamplingFactor.F_1_1, 3),
    "cmyk_seq": (JpegColorType.CMYK, SamplingFactor.F_2_1, None),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_scan_histograms_match(mode):
    """scan_histograms == tpuenc.entropy.device.scan_histograms (the Pallas
    route, interpret) and huffopt.build_histograms on the host, without the
    reserved-symbol seed.  The DC counts chain over the whole stream; a
    13-scan plan has 12 bands, two K7 launches per component."""
    jct, sf, scans = MODES[mode]
    comps = init_components(jct, sf)
    streams = [_stream(300, 10 * i + len(mode)) for i in range(len(comps))]
    got = tdevice.scan_histograms([torch.from_numpy(s) for s in streams],
                                  comps, scans).numpy()
    want = jdevice.scan_histograms([jnp.asarray(s) for s in streams], comps,
                                   scans, cm=True, pallas=True)
    host = jhuffopt.build_histograms([s.T for s in streams], comps, scans)
    assert got.shape == (min(len(comps), 2), 2, 257)
    for t, ((jdc, jac), (hdc, hac)) in enumerate(zip(want, host)):
        np.testing.assert_array_equal(got[t, 0], np.asarray(jdc))
        np.testing.assert_array_equal(got[t, 1], np.asarray(jac))
        hdc, hac = hdc.copy(), hac.copy()
        hdc[256] = hac[256] = 0
        np.testing.assert_array_equal(got[t, 0], hdc)
        np.testing.assert_array_equal(got[t, 1], hac)


def _histograms(seed):
    rng = np.random.default_rng(seed)
    freq = np.zeros(257, np.int64)
    if seed % 3 == 0:  # Fibonacci-like skew: code lengths past 16 get limited
        a, b = 1, 1
        for i in range(40):
            freq[(i * 7) % 256] = a
            a, b = b, a + b
    else:
        n = rng.integers(1, 256)
        idx = rng.choice(256, n, replace=False)
        freq[idx] = rng.integers(1, 10 ** (seed % 6 + 1), n)
    freq[256] = 1
    return freq


@pytest.mark.parametrize("seed", range(6))
def test_build_k2_matches_python(seed):
    """The native K.2 build (the unchanged native/entropy.cpp) gives the
    Python build's tables, through both packages' bindings."""
    freq = _histograms(seed)
    want = ttables._optimized_huffman_table_py(freq)
    lengths, values = tnative.build_k2(freq)
    assert (tuple(lengths), tuple(values)) == (want.lengths, want.values)
    assert (lengths, values) == jnative.build_k2(freq)
    got = ttables.optimized_huffman_table(freq)
    np.testing.assert_array_equal(got.sizes, want.sizes)
    np.testing.assert_array_equal(got.codes, want.codes)
    jt = jtables._optimized_huffman_table_py(freq)
    np.testing.assert_array_equal(got.codes, jt.codes)


def test_build_k2_declines_degenerate():
    """A histogram of the reserved symbol alone: both bindings return None
    (the caller then runs the Python build, which refuses it too)."""
    freq = np.zeros(257, np.int64)
    freq[256] = 1
    assert tnative.build_k2(freq) is None
    assert jnative.build_k2(freq) is None
    with pytest.raises(ValueError):
        tnative.build_k2(np.zeros(256, np.int64))


@pytest.mark.parametrize("sf,scans,ct", [
    ("F_1_1", 4, ColorType.RGB),
    ("F_2_2", 64, ColorType.RGB),
    ("F_4_1", None, ColorType.CMYK),
    ("F_1_1", 3, ColorType.LUMA),
])
def test_exact_stream_bits_matches_stream(sf, scans, ct):
    """exact_stream_bits from the device histograms and the K.2 tables ==
    the bits the packer writes with those tables (no restart interval: the
    histogram's DC chain then matches the scans'), and the budget hint
    equals tpuenc's."""
    w, h = 48, 40
    cfg = EncoderConfig(quality=90, sampling_factor=SamplingFactor[sf],
                        progressive_scans=scans, optimize_huffman_table=True)
    shape = (h, w, ct.bytes_per_pixel) if ct.bytes_per_pixel > 1 else (h, w)
    px = np.random.default_rng(w + (scans or 0)).integers(0, 256, shape,
                                                          np.uint8)
    q = [ttables.quantization_table("default", 90, True),
         ttables.quantization_table("default", 90, False)]
    recip, corr = tde.quant_params(q, "cpu")
    streams = tpipe.fn_cm(torch.from_numpy(px), w, h, ct, cfg, recip, corr)
    layout = tpipe.scan_layout(w, h, ct, cfg)
    comps = layout["components"]
    hists = tdevice.scan_histograms(streams, comps, scans).numpy()
    pairs = [(hh[0], hh[1]) for hh in hists]
    huffman = [list(p) for p in ttables.default_tables()]
    for i, tabs in enumerate(thuffopt.tables_from_histograms(pairs)):
        huffman[i] = list(tabs)
    bits = thuffopt.exact_stream_bits(pairs, huffman[:len(pairs)])
    params = tde.EncodeParams(recip, corr, *tde.huffman_params(huffman, "cpu"))
    plan = tde.build_scan_plan(layout, comps, cfg)
    _, meta = tde._pack_scans_v2(streams, plan, params, 224)
    assert bits == int(meta[1:1 + len(plan)].sum())
    from tpuenc_torch.api import _plan_pack_rows

    rows = _plan_pack_rows(w, h, ct, cfg)
    assert (thuffopt.budget_hint_from_bits(bits, rows)
            == jhuffopt.budget_hint_from_bits(bits, rows))
