"""tpuenc_torch's sequential and progressive packing (K6, the DC path, the
empty band, the multi-scan P1-P4 merge) against tpuenc on the CPU, bit for
bit (tolerance 0).

The port's wrappers run the kernels' plain PyTorch versions on CPU
tensors; the JAX side runs its Pallas kernels in interpret mode.  Bit words
are compared as int32 bit patterns.  Where a stage overflows, the budget
ladder discards its words on both sides, so only the flag and the lengths
are compared.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpuenc.core.tables import default_tables  # noqa: E402
from tpuenc.core.types import ColorType as JColorType  # noqa: E402
from tpuenc.core.types import EncoderConfig as JConfig  # noqa: E402
from tpuenc.core.types import SamplingFactor as JSampling  # noqa: E402
from tpuenc.entropy import device_encode as jde  # noqa: E402
from tpuenc.entropy import pallas_pack as jpack  # noqa: E402
from tpuenc.entropy.device_pack import ScanSpec  # noqa: E402
from tpuenc.kernels.pipeline import coefficients_fn  # noqa: E402
from tpuenc_torch.core.tables import quantization_table as tquant  # noqa: E402
from tpuenc_torch.core.types import ColorType, EncoderConfig, SamplingFactor  # noqa: E402
from tpuenc_torch.entropy import device_encode as tde  # noqa: E402
from tpuenc_torch.entropy import pallas_pack as tpack  # noqa: E402
from tpuenc_torch.entropy.device_pack import ScanSpec as TScanSpec  # noqa: E402
from tpuenc_torch.entropy.huffopt import progressive_bands  # noqa: E402
from tpuenc_torch.kernels import pipeline as tpipe  # noqa: E402

HUFFMAN = [list(p) for p in default_tables()]
ARRAYS = jde.tables_to_arrays(HUFFMAN)
JDC, JAC = jpack.pack_tables(ARRAYS)


def _tparams():
    q = [tquant("default", 90, True), tquant("default", 90, False)]
    return tde.params_from_numpy(q, *ARRAYS, "cpu")


def _blocks(B, seed, dense=False):
    """Coefficient-major (64, B) int16 blocks: sparse blocks with long zero
    runs (ZRL), all-zero bands, and with ``dense`` a few blocks of large
    coefficients in every slot (they overflow rung 16's block caps)."""
    rng = np.random.default_rng(seed)
    q = np.zeros((64, B), np.int16)
    mask = rng.random((64, B)) < 0.2
    q[mask] = rng.integers(-300, 300, (64, B))[mask]
    q[0] = rng.integers(-1000, 1000, B)
    q[1:40, 1::7] = 0                          # runs of >= 16 zeros
    q[45, 1::7] = rng.integers(1, 50, q[45, 1::7].shape)
    q[:, 3::11] = rng.integers(-60, 60, (64, q[:, 3::11].shape[1]))
    q[1:, 5::13] = 0                           # DC-only blocks
    q[20:, 6::9] = 0                           # empty high bands
    if dense:
        q[:, 10:14] = rng.integers(-900, 900, (64, 4))
    return q


def _band_specs(bands, tab=1):
    return [ScanSpec(ss, se, False, True, (tab,), (tab,), (1,), 0)
            for ss, se in bands]


BANDS = {
    "2": progressive_bands(3),                 # (1, 32) (32, 64)
    "3": progressive_bands(4),                 # the flagship's bands
    "4": progressive_bands(13)[4:8],           # four narrow mid bands
    "4_empty": progressive_bands(34)[:4],      # (1, 1) (1, 2) (2, 3) (3, 4)
    "1_full": [(1, 64)],
}


@pytest.mark.parametrize("name,budget", [
    ("2", 16), ("2", 224),
    ("3", 16), ("3", 48), ("3", 224),   # dense blocks: rung 16 overflows
    ("4", 48), ("4_empty", 16), ("1_full", 224),
])
def test_k6_matches_pallas(name, budget):
    """K6's plain version == scan_pack_blocks_acbands(interpret, cm,
    tile=32): per band words and lengths, and the one overflow flag."""
    q = _blocks(100, len(name), dense=name == "3")
    specs = _band_specs(BANDS[name])
    jouts, jo = jpack.scan_pack_blocks_acbands(
        jnp.asarray(q), specs, JAC, budget, tile=32, interpret=True, cm=True)
    touts, to = tpack.scan_pack_blocks_acbands(
        torch.from_numpy(q), [TScanSpec(*s) for s in specs], _tparams().ac,
        budget, tile=32)
    assert bool(to.item()) == bool(jo)
    if name == "3":
        assert bool(jo) == (budget == 16)
    for (jw, jl), (tw, tl) in zip(jouts, touts):
        jw = np.asarray(jw).view(np.int32)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert tw.shape == jw.shape
        if not bool(jo):
            np.testing.assert_array_equal(tw.numpy(), jw)


def test_band_tree_caps_match():
    for budget in (16, 48, 224):
        for scans in (2, 4, 13, 34, 64):
            for ss, se in progressive_bands(scans):
                if ss < se:
                    assert (tpack.band_tree_caps(budget, ss, se)
                            == jpack.band_tree_caps(budget, ss, se))


@pytest.mark.parametrize("pattern,seg", [((0,), 0), ((1,), 5), ((0, 1), 3)])
def test_dc_only_matches_pallas(pattern, seg):
    """The DC path (plain PyTorch on both sides of the port) and K2 with a
    DC-only scan, against tpuenc's DC path and its P1 kernel."""
    q = _blocks(150, seg)
    delta = jde._dc_prev_delta(pattern)
    spec = ScanSpec(1, 1, True, False, pattern, pattern, delta, seg)
    jw, jl, jo = jpack._dc_only_pack_blocks(jnp.asarray(q), spec, JDC, 32,
                                            cm=True)
    p = _tparams()
    tw, tl, to = tpack.dc_only_pack_blocks(torch.from_numpy(q), TScanSpec(*spec),
                                           p.dc, 32)
    assert not bool(to.item()) and not bool(jo)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int32))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    kw, kl, ko = jpack.scan_pack_blocks(jnp.asarray(q), spec, JDC, JAC, 16,
                                        tile=32, interpret=True, cm=True)
    uw, ul, uo = tpack.scan_pack_blocks(torch.from_numpy(q), TScanSpec(*spec),
                                        p.dc, p.ac, 16, tile=32)
    assert bool(uo.item()) == bool(ko)
    np.testing.assert_array_equal(ul.numpy(), np.asarray(kl))
    np.testing.assert_array_equal(uw.numpy(), np.asarray(kw).view(np.int32))
    np.testing.assert_array_equal(ul.numpy(), tl.numpy())


def test_empty_band_matches_pallas():
    """Band [1, 1) emits 0 bits per block and no EOB."""
    q = _blocks(70, 3)
    spec = ScanSpec(1, 1, False, True, (0,), (0,), (1,), 0)
    jw, jl, jo = jpack.scan_pack_blocks(jnp.asarray(q), spec, JDC, JAC, 16,
                                        tile=32, interpret=True, cm=True)
    p = _tparams()
    tw, tl, to = tpack.scan_pack_blocks(torch.from_numpy(q), TScanSpec(*spec),
                                        p.dc, p.ac, 16, tile=32)
    assert tw.shape == np.asarray(jw).shape == (96, 1)
    assert not tw.any() and not tl.any() and not bool(to.item()) and not bool(jo)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


PLANS = {
    "progressive4_rst3": (JColorType.RGB, JSampling.F_1_1, 4, 3),
    "progressive7_luma": (JColorType.LUMA, JSampling.F_1_1, 7, 0),  # K6: 4 + 2
    "progressive2_rst2": (JColorType.RGB, JSampling.F_1_1, 2, 2),  # K2 per band
    "sequential_f41": (JColorType.RGB, JSampling.F_4_1, None, 4),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_pack_scans_meta_matches(name):
    """The multi-scan P1 + shared P2-P4 of the port == tpuenc's
    ``_pack_scans_v2`` (interpret mode): ``meta`` (overflow flag, scan
    bits, segment bits), the raw stream's bits, and the finished scans."""
    jct, sf, scans, rst = PLANS[name]
    ct = ColorType(jct.value)
    w, h = 40, 27
    jcfg = JConfig(quality=90, sampling_factor=sf, progressive_scans=scans,
                   restart_interval=rst or None)
    tcfg = EncoderConfig(quality=90, sampling_factor=SamplingFactor[sf.name],
                         progressive_scans=scans, restart_interval=rst or None)
    shape = (h, w) if ct is ColorType.LUMA else (h, w, 3)
    px = np.random.default_rng(len(name)).integers(0, 256, shape, np.uint8)
    fn, _ = coefficients_fn(w, h, jct, jcfg)
    streams = [np.ascontiguousarray(np.asarray(s).T) for s in fn(px)]
    layout = tpipe.scan_layout(w, h, ct, tcfg)
    plan = tde.build_scan_plan(layout, layout["components"], tcfg)
    seg_structure = tde.seg_structure(layout, plan)
    jplan = jde.build_scan_plan(layout, layout["components"], jcfg)
    budget = 16
    jbuf, jmeta = jde._pack_scans_v2(
        tuple(jnp.asarray(s) for s in streams), jplan, JDC, JAC, budget,
        interpret=True, cm=True)
    tbuf, tmeta = tde._pack_scans_v2(
        tuple(torch.from_numpy(s) for s in streams), plan, _tparams(), budget)
    jmeta = np.asarray(jmeta)
    np.testing.assert_array_equal(tmeta.numpy(), jmeta)
    assert jmeta[0] == 0
    n = (int(jmeta[1:1 + len(plan)].sum()) + 31) >> 5
    np.testing.assert_array_equal(tbuf[:n].numpy(),
                                  np.asarray(jbuf)[:n].view(np.int32))
    want = jde._finish_scans_v2(np.asarray(jbuf), jmeta, jplan, seg_structure)
    got = tde._finish_scans_v2(tbuf, tmeta.numpy()[1 + len(plan):],
                               seg_structure)
    assert len(got) == len(plan) > 1
    assert got == want


@pytest.mark.parametrize("sf", ["F_1_4", "F_4_2", "F_2_2"])
def test_per_component_streams_match(sf):
    """fn_cm's sequential/progressive branch: one raster stream per
    component, cropped to the component's own block grid."""
    w, h = 37, 29
    jcfg = JConfig(quality=85, sampling_factor=JSampling[sf],
                   progressive_scans=3)
    tcfg = EncoderConfig(quality=85, sampling_factor=SamplingFactor[sf],
                         progressive_scans=3)
    px = np.random.default_rng(w).integers(0, 256, (h, w, 3), np.uint8)
    fn, _ = coefficients_fn(w, h, JColorType.RGB, jcfg)
    want = [np.asarray(s).T for s in fn(px)]
    p = _tparams()
    q = [tquant("default", 85, True), tquant("default", 85, False)]
    recip, corr = tde.quant_params(q, "cpu")
    got = tpipe.fn_cm(torch.from_numpy(px), w, h, ColorType.RGB, tcfg,
                      recip, corr)
    assert p.dc.shape == (1, 128)
    assert len(got) == len(want) == 3
    counts = tpipe.scan_layout(w, h, ColorType.RGB, tcfg)["comp_block_counts"]
    for g, x, n in zip(got, want, counts):
        assert g.shape == (64, n)
        np.testing.assert_array_equal(g.numpy(), x)
