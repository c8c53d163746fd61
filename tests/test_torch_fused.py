"""tpuenc_torch's fused route (K8) against tpuenc on the CPU, bit for bit
(tolerance 0: every stage is integer arithmetic).

The sample stream against ``raw_fn_cm_samples``; K8's plain version
against tpuenc's K8 in interpret mode and against tpuenc's split path
(coefficients, then ``scan_pack_blocks`` in interpret mode); whole files
through ``Encoder(..., fused_p1=True)`` against the frozen fixtures and the
split path.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpuenc.core.tables import ZIGZAG, default_tables  # noqa: E402
from tpuenc.core.tables import quantization_table  # noqa: E402
from tpuenc.core.types import ColorType, EncoderConfig, SamplingFactor  # noqa: E402
from tpuenc.entropy import pallas_pack as jpack  # noqa: E402
from tpuenc.entropy.device_encode import build_scan_plan  # noqa: E402
from tpuenc.entropy.device_encode import tables_to_arrays  # noqa: E402
from tpuenc.kernels.pipeline import _build_coefficients_fn_impl  # noqa: E402
from tpuenc.kernels.pipeline import coefficients_fn  # noqa: E402
import tpuenc_torch as tt  # noqa: E402
from tpuenc_torch.core import tables as ttables  # noqa: E402
from tpuenc_torch.core import types as ttypes  # noqa: E402
from tpuenc_torch.entropy import device_encode as tde  # noqa: E402
from tpuenc_torch.entropy import pallas_pack as tpack  # noqa: E402
from tpuenc_torch.entropy.device_pack import ScanSpec as TScanSpec  # noqa: E402
from tpuenc_torch.kernels import pipeline as tpipe  # noqa: E402
from tpuenc_torch.testing.fixtures import build_cases, img  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
HUFFMAN = [list(p) for p in default_tables()]
ARRAYS = tables_to_arrays(HUFFMAN)
JDC, JAC = jpack.pack_tables(ARRAYS)


def _config(q, sf, restart=None, quant=("default", "default")):
    return EncoderConfig(quality=q, sampling_factor=sf, restart_interval=restart,
                         quantization=quant)


def _tconfig(config):
    return ttypes.EncoderConfig(
        quality=config.quality,
        sampling_factor=ttypes.SamplingFactor(config.sampling_factor.value),
        restart_interval=config.restart_interval,
        quantization=config.quantization)


def _pixels(w, h, ch, seed, amp=50):
    """Gradients with noise of +-``amp``: smooth and busy blocks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 5 + yy * 3) % 256)[..., None]
    px = np.clip(base + rng.integers(-amp, amp, (h, w, ch)), 0, 255)
    px = px.astype(np.uint8)
    return px[..., 0] if ch == 1 else px


# name -> (color type, channels, sampling, quality, width, height); the
# MCUs hold 3, 6, 4, 1, 7 and 10 blocks.
CASES = {
    "rgb444": (ColorType.RGB, 3, SamplingFactor.F_1_1, 90, 37, 21),
    "rgb420": (ColorType.RGB, 3, SamplingFactor.F_2_2, 80, 37, 21),
    "rgb21": (ColorType.RGB, 3, SamplingFactor.F_2_1, 75, 19, 30),
    "luma": (ColorType.LUMA, 1, SamplingFactor.F_2_2, 70, 23, 17),
    "cmyk": (ColorType.CMYK, 4, SamplingFactor.F_2_2, 85, 26, 19),
    "ycck420": (ColorType.CMYK_AS_YCCK, 4, SamplingFactor.F_2_2, 85, 26, 19),
}
PATTERN = {"rgb444": 3, "rgb420": 6, "rgb21": 4, "luma": 1, "cmyk": 7,
           "ycck420": 10}


def _case(name, restart=None, quant=("default", "default")):
    ct, ch, sf, q, w, h = CASES[name]
    return ct, _pixels(w, h, ch, len(name)), w, h, _config(q, sf, restart, quant)


def _tsamples(px, w, h, ct, config):
    return tpipe.fn_cm_samples(torch.from_numpy(px), w, h,
                               ttypes.ColorType(ct.value), _tconfig(config))


def _tparams(config):
    q = [ttables.quantization_table(config.quantization[0], config.quality, True),
         ttables.quantization_table(config.quantization[1], config.quality, False)]
    return tde.params_from_numpy(q, *ARRAYS, "cpu")


def _plan(w, h, ct, config):
    """tpuenc's single interleaved scan: (layout, spec, qtab pattern)."""
    _, layout = coefficients_fn(w, h, ct, config)
    ((_, spec, _),) = build_scan_plan(layout, layout["components"], config)
    comps = layout["components"]
    qtabs = tuple(comps[c].quantization_table for c in layout["mcu_block_comps"])
    return layout, spec, qtabs


@pytest.mark.parametrize("name", sorted(CASES))
def test_fn_cm_samples_matches_tpuenc(name):
    """The port's MCU-ordered int16 sample stream == tpuenc's
    raw_fn_cm_samples, and its quantizer pattern == tpuenc's layout's."""
    ct, px, w, h, config = _case(name)
    fn, _ = _build_coefficients_fn_impl(w, h, ct, config, False, True)
    want = np.asarray(fn.raw_fn_cm_samples(jnp.asarray(px)))
    got = _tsamples(px, w, h, ct, config)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    _, _, qtabs = _plan(w, h, ct, config)
    layout = tpipe.scan_layout(w, h, ttypes.ColorType(ct.value), _tconfig(config))
    assert tde.qtab_pattern(layout) == qtabs and len(qtabs) == PATTERN[name]


def test_fn_cm_samples_takes_interleaved_configs():
    config = ttypes.EncoderConfig(quality=90, progressive_scans=3)
    with pytest.raises(ValueError, match="interleaved"):
        tpipe.fn_cm_samples(torch.zeros((8, 8, 3), dtype=torch.uint8), 8, 8,
                            ttypes.ColorType.RGB, config)


def _jax_fused(samples, spec, qtabs, config, budget, tile):
    q = [quantization_table(config.quantization[0], config.quality, True),
         quantization_table(config.quantization[1], config.quality, False)]
    recip2 = np.stack([np.asarray(t.reciprocals)[ZIGZAG] for t in q], 1)
    corr2 = np.stack([np.asarray(t.corrections)[ZIGZAG] for t in q], 1)
    w, l, o = jpack.fused_sample_pack_blocks(
        jnp.asarray(samples), spec, qtabs, jnp.asarray(recip2.astype(np.int32)),
        jnp.asarray(corr2.astype(np.int32)), JDC, JAC, budget, tile=tile,
        interpret=True)
    return np.asarray(w).view(np.int32), np.asarray(l), bool(o)


def _torch_fused(samples, spec, qtabs, config, budget, tile):
    w, l, o = tpack.fused_sample_pack_blocks(
        samples, TScanSpec(*spec), qtabs, _tparams(config), budget, tile=tile)
    return w.numpy(), l.numpy(), bool(o.item())


def test_k8_plain_matches_tpuenc_k8():
    """K8's plain version == tpuenc's K8 (interpret mode, 128-block tiles)
    on a 96x96 4:2:0 image with restart interval 5: 216 blocks in two
    tiles, so tpuenc's DC carry crosses a tile, and the segments of 30
    blocks start on both sides of the tile edge (120, 150)."""
    ct, w, h = ColorType.RGB, 96, 96
    config = _config(80, SamplingFactor.F_2_2, 5)
    px = _pixels(w, h, 3, 96)
    _, spec, qtabs = _plan(w, h, ct, config)
    samples = _tsamples(px, w, h, ct, config)
    B = samples.shape[1]
    assert B == 216 and spec.seg_blocks == 30
    jw, jl, jo = _jax_fused(samples.numpy(), spec, qtabs, config, 16, 128)
    tw, tl, to = _torch_fused(samples, spec, qtabs, config, 16, 128)
    assert tw.shape == jw.shape and to == jo
    np.testing.assert_array_equal(tl[:B], jl[:B])
    np.testing.assert_array_equal(tw[:B], jw[:B])
    assert not tl[B:].any()


def _split_jax(px, w, h, ct, config, spec, budget, tile):
    """tpuenc's split path: the coefficient stream, then P1 in interpret
    mode."""
    fn, _ = coefficients_fn(w, h, ct, config)
    (coeffs,) = fn(jnp.asarray(px))
    stream = jnp.asarray(np.asarray(coeffs).T)
    wds, lens, ovf = jpack.scan_pack_blocks(stream, spec, JDC, JAC, budget,
                                            tile=tile, interpret=True, cm=True)
    return np.asarray(wds).view(np.int32), np.asarray(lens), bool(ovf)


@pytest.mark.parametrize("restart", [None, 2], ids=["no_restart", "restart2"])
@pytest.mark.parametrize("budget", [16, 48])
@pytest.mark.parametrize("name", sorted(CASES))
def test_k8_plain_matches_split(name, budget, restart):
    """K8's plain version == tpuenc's coefficients -> scan_pack_blocks
    (interpret, 32-block tiles): words, lengths and the flag, for MCUs of
    1, 3, 4, 6, 7 and 10 blocks."""
    ct, px, w, h, config = _case(name, restart)
    _, spec, qtabs = _plan(w, h, ct, config)
    want = _split_jax(px, w, h, ct, config, spec, budget, 32)
    got = _torch_fused(_tsamples(px, w, h, ct, config), spec, qtabs, config,
                       budget, 32)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_k8_plain_matches_split_q100_flat():
    """The flat q100 quantizer (the reciprocal's int32 wrap-around) on
    uniform noise: overflows at block budget 16, fits at 48."""
    ct, w, h = ColorType.RGB, 37, 21
    config = _config(100, SamplingFactor.F_1_1, quant=("flat", "flat"))
    px = np.random.default_rng(3).integers(0, 256, (h, w, 3), np.uint8)
    _, spec, qtabs = _plan(w, h, ct, config)
    samples = _tsamples(px, w, h, ct, config)
    for budget in (16, 48):
        want = _split_jax(px, w, h, ct, config, spec, budget, 32)
        got = _torch_fused(samples, spec, qtabs, config, budget, 32)
        assert got[2] == want[2] == (budget == 16)
        np.testing.assert_array_equal(got[1], want[1])
        if not got[2]:
            np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("name", sorted(build_cases("cpu")))
def test_fused_fixtures(name):
    """With fused_p1=True the 17 interleaved fixtures go through K8's
    route and the 9 others through the split path; every file is
    unchanged."""
    build, ct, ch, seed, w, h = build_cases("cpu", fused_p1=True)[name]
    want = open(os.path.join(HERE, "fixtures", f"{name}.jpg"), "rb").read()
    enc = build()
    assert enc.encode(img(ch, seed, w, h), w, h, ct) == want
    fused = enc._config().mode() == "interleaved"
    assert enc.last_encode_path == ("device-v2-fused" if fused else "device-v2")


@pytest.mark.parametrize("w,h,sf,quality,restart,amp", [
    (320, 240, "F_1_1", 90, 0, 50),
    (352, 288, "F_2_2", 90, 7, 100),
])
def test_fused_matches_split_rung(w, h, sf, quality, restart, amp):
    """A larger interleaved image, each route learning its rung afresh:
    the same bytes and the same budget rung.  Both images overflow the
    8-slot window cap of block budget 16, so every rung to 16 overflows
    and the fused route's own P1 flag drives the ladder to 48."""
    px = _pixels(w, h, 3, w, amp)
    out = {}
    for fused in (False, True):
        tde._budget_memo.clear()
        enc = tt.Encoder(quality, device="cpu", fused_p1=fused)
        enc.set_sampling_factor(tt.SamplingFactor[sf])
        enc.set_restart_interval(restart)
        out[fused] = (enc.encode(px, w, h, tt.ColorType.RGB), enc.last_budget,
                      enc.last_encode_path)
    assert out[True][:2] == out[False][:2]
    assert out[True][1] == 48
    assert (out[False][2], out[True][2]) == ("device-v2", "device-v2-fused")


def test_fused_route_is_explicit():
    """fused_p1 is routing by mode, never a fallback: the non-interleaved
    modes report the split path, and device_encode_scans refuses a fused
    request it cannot serve."""
    px = _pixels(16, 16, 3, 0)
    enc = tt.Encoder(90, device="cpu", fused_p1=True)
    enc.set_progressive(True)
    enc.encode(px, 16, 16, tt.ColorType.RGB)
    assert enc.last_encode_path == "device-v2"
    plan = enc._plan(16, 16, tt.ColorType.RGB)
    assert plan.route == "device-v2"
    params = _tparams(_config(90, SamplingFactor.F_1_1))
    with pytest.raises(ValueError, match="interleaved"):
        tde.device_encode_scans(torch.from_numpy(px),
                                plan._replace(route="device-v2-fused"), params)
    sink = []

    class Sink:
        def write(self, data):
            sink.append(data)

    w = tt.Encoder.new_writer(Sink(), 90, device="cpu", fused_p1=True)
    w.encode(px, 16, 16, tt.ColorType.RGB)
    assert w.fused_p1 and w.last_encode_path == "device-v2-fused"
    assert sink[0] == tt.Encoder(90, device="cpu").encode(px, 16, 16,
                                                         tt.ColorType.RGB)
