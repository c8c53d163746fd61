"""The interleaved frozen fixtures (``tests/fixtures/<name>.jpg``), rebuilt
for the port.

Same inputs and encoder settings as ``tests/fixtures/generate.py``, which
stays as it is (it builds ``tpuenc`` encoders and imports JAX); this map
builds ``tpuenc_torch`` encoders on a given device.  Only the 17 fixtures
whose scan is interleaved with default tables are here: the sequential,
progressive and optimized-table ones wait for ROADMAP M6/M7.
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

    def enc(q, sampling=None, restart=None):
        def build():
            e = Encoder(q, device=device)
            if sampling is not None:
                e.set_sampling_factor(sampling)
            if restart is not None:
                e.set_restart_interval(restart)
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
    }
