"""The 26 frozen fixtures (``tests/fixtures/<name>.jpg``), rebuilt for the
port.

Same inputs and encoder settings as ``tests/fixtures/generate.py``, which
stays as it is (it builds ``tpuenc`` encoders and imports JAX); this map
builds ``tpuenc_torch`` encoders on a given device.  It covers every mode:
interleaved, sequential and progressive scans, default and optimized
tables.
"""

from __future__ import annotations

import numpy as np

from ..api import Encoder
from ..core.types import ColorType, PixelDensity, SamplingFactor

W, H = 26, 19  # partial trailing MCU both ways at 2x2 sampling
GEOM_W, GEOM_H = 258, 172  # reference partial-MCU stress width (lib.rs:82)


def img(ch, seed, w=W, h=H):
    """The fixture's pixels: ``generate.py:_img``."""
    rng = np.random.default_rng(seed)
    shape = (h, w) if ch == 1 else (h, w, ch)
    return rng.integers(0, 256, shape, np.uint8)


def _icc_bytes():
    return bytes(np.random.default_rng(1234).integers(0, 256, 70000, np.uint8))


def build_cases(device):
    """name -> (encoder factory, color type, channels, seed, width, height),
    as ``generate.py:build_cases`` with every encoder on ``device``."""

    def enc(q, sampling=None, restart=None, scans=None, optimize=False):
        def build():
            e = Encoder(q, device=device)
            if sampling is not None:
                e.set_sampling_factor(sampling)
            if restart is not None:
                e.set_restart_interval(restart)
            if scans is not None:
                e.set_progressive_scans(scans)
            if optimize:
                e.set_optimized_huffman_tables(True)
            return e
        return build

    def custom_q():
        e = Encoder(50, device=device)  # quality is ignored for custom tables
        e.set_quantization_tables([1] * 64, [1] * 64)
        return e

    def preset_q():
        e = Encoder(80, device=device)
        e.set_quantization_tables("custom_ms_ssim", "custom_ms_ssim")
        return e

    def icc():
        e = Encoder(90, device=device)
        e.add_icc_profile(_icc_bytes())
        return e

    def metadata():
        e = Encoder(88, device=device)
        e.add_exif_metadata(b"II*\x00\x08\x00\x00\x00tpuenc-exif")
        e.add_app_segment(5, b"tpuenc-fixture-app5")
        e.set_density(PixelDensity.dpi(300))
        return e

    def q100_flat():
        e = Encoder(100, device=device)
        e.set_quantization_tables("flat", "flat")
        return e

    F22 = SamplingFactor.F_2_2
    return {
        "baseline_q90_444": (enc(90), ColorType.RGB, 3, 0, W, H),
        "restart2_q80_420": (enc(80, F22, 2), ColorType.RGB, 3, 1, W, H),
        "luma_q85": (enc(85), ColorType.LUMA, 1, 6, W, H),
        "cmyk_q85": (enc(85), ColorType.CMYK, 4, 7, W, H),
        "ycck_q85_420": (enc(85, F22), ColorType.CMYK_AS_YCCK, 4, 8, W, H),
        "f21_q80": (enc(80, SamplingFactor.F_2_1), ColorType.RGB, 3, 9, W, H),
        "f12_q80": (enc(80, SamplingFactor.F_1_2), ColorType.RGB, 3, 10, W, H),
        "customq_allones": (custom_q, ColorType.RGB, 3, 14, W, H),
        "preset_msssim_q80": (preset_q, ColorType.RGB, 3, 15, W, H),
        "icc_2chunk_q90": (icc, ColorType.RGB, 3, 17, W, H),
        "exif_app5_dpi300_q88": (metadata, ColorType.RGB, 3, 18, W, H),
        "geom258x172_q90_444": (enc(90), ColorType.RGB, 3, 19, GEOM_W, GEOM_H),
        "geom258x172_rst4_q80_420": (
            enc(80, F22, 4), ColorType.RGB, 3, 20, GEOM_W, GEOM_H),
        "q1_extreme": (enc(1), ColorType.RGB, 3, 21, W, H),
        "q100_flat": (q100_flat, ColorType.RGB, 3, 22, W, H),
        "ycbcr_passthrough_q88": (enc(88), ColorType.YCBCR, 3, 23, W, H),
        "bgra_q90": (enc(90), ColorType.BGRA, 4, 24, W, H),
        # Sequential, progressive and optimized-table modes.
        "progressive4_q90": (enc(90, scans=4), ColorType.RGB, 3, 2, W, H),
        "optimized_q95": (enc(95, optimize=True), ColorType.RGB, 3, 3, W, H),
        "factor4_seq_q85": (
            enc(85, SamplingFactor.F_4_1), ColorType.RGB, 3, 4, W, H),
        "opt_prog3_rst3_q90": (
            enc(90, restart=3, scans=3, optimize=True), ColorType.RGB, 3, 5,
            W, H),
        "f14_seq_q85": (
            enc(85, SamplingFactor.F_1_4), ColorType.RGB, 3, 11, W, H),
        "f42_seq_q75": (
            enc(75, SamplingFactor.F_4_2), ColorType.RGB, 3, 12, W, H),
        "f24_seq_q75": (
            enc(75, SamplingFactor.F_2_4), ColorType.RGB, 3, 13, W, H),
        "ycck_prog4_rst2_q90": (
            enc(90, F22, 2, scans=4), ColorType.CMYK_AS_YCCK, 4, 16, W, H),
        "luma_prog3_q85": (enc(85, scans=3), ColorType.LUMA, 1, 25, W, H),
    }
