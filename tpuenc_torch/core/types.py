"""Core configuration types.

Hashable equivalents of the reference's config
surface:

* ``JpegColorType``   — reference encoder.rs:23-35
* ``ColorType``       — reference encoder.rs:72-110
* ``SamplingFactor``  — reference encoder.rs:113-188 (packed u8 repr, aliases,
                        ``supports_interleaved`` for the factor-4 sequential
                        fallback)
* ``PixelDensity``    — reference writer.rs:16-59
* ``Component``       — reference encoder.rs:190-210, init table mapping at
                        encoder.rs:569-619
* ``EncoderConfig``   — the frozen snapshot of every Encoder setter
                        (encoder.rs:277-435), used as a cache key.

Everything in here is plain Python (cold path) and hashable so the whole
config can key the encoder's caches.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Tuple


class JpegColorType(enum.Enum):
    """Colorspace written into the JPEG frame (reference encoder.rs:23-35)."""

    LUMA = "luma"
    YCBCR = "ycbcr"
    CMYK = "cmyk"
    YCCK = "ycck"

    @property
    def num_components(self) -> int:
        return {
            JpegColorType.LUMA: 1,
            JpegColorType.YCBCR: 3,
            JpegColorType.CMYK: 4,
            JpegColorType.YCCK: 4,
        }[self]


class ColorType(enum.Enum):
    """Input pixel formats (reference encoder.rs:72-99)."""

    LUMA = "luma"
    RGB = "rgb"
    RGBA = "rgba"
    BGR = "bgr"
    BGRA = "bgra"
    YCBCR = "ycbcr"
    CMYK = "cmyk"
    CMYK_AS_YCCK = "cmyk_as_ycck"
    YCCK = "ycck"

    @property
    def bytes_per_pixel(self) -> int:
        return {
            ColorType.LUMA: 1,
            ColorType.RGB: 3,
            ColorType.BGR: 3,
            ColorType.YCBCR: 3,
            ColorType.RGBA: 4,
            ColorType.BGRA: 4,
            ColorType.CMYK: 4,
            ColorType.CMYK_AS_YCCK: 4,
            ColorType.YCCK: 4,
        }[self]

    @property
    def jpeg_color_type(self) -> JpegColorType:
        return {
            ColorType.LUMA: JpegColorType.LUMA,
            ColorType.RGB: JpegColorType.YCBCR,
            ColorType.RGBA: JpegColorType.YCBCR,
            ColorType.BGR: JpegColorType.YCBCR,
            ColorType.BGRA: JpegColorType.YCBCR,
            ColorType.YCBCR: JpegColorType.YCBCR,
            ColorType.CMYK: JpegColorType.CMYK,
            ColorType.CMYK_AS_YCCK: JpegColorType.YCCK,
            ColorType.YCCK: JpegColorType.YCCK,
        }[self]


class SamplingFactor(enum.Enum):
    """Chroma subsampling factors with the reference's packed u8 values.

    Reference encoder.rs:113-188.  The ``R_*`` variants are aliases whose
    packed value has bit 7 set; ``get_sampling_factors`` masks it away.
    Factor-4 variants are not representable in interleaved MCU mode and force
    the sequential fallback (encoder.rs:178-187).
    """

    F_1_1 = (1 << 4) | 1
    F_2_1 = (2 << 4) | 1
    F_1_2 = (1 << 4) | 2
    F_2_2 = (2 << 4) | 2
    F_4_1 = (4 << 4) | 1
    F_4_2 = (4 << 4) | 2
    F_1_4 = (1 << 4) | 4
    F_2_4 = (2 << 4) | 4

    R_4_4_4 = 0x80 | (1 << 4) | 1
    R_4_4_0 = 0x80 | (1 << 4) | 2
    R_4_4_1 = 0x80 | (1 << 4) | 4
    R_4_2_2 = 0x80 | (2 << 4) | 1
    R_4_2_0 = 0x80 | (2 << 4) | 2
    R_4_2_1 = 0x80 | (2 << 4) | 4
    R_4_1_1 = 0x80 | (4 << 4) | 1
    R_4_1_0 = 0x80 | (4 << 4) | 2

    @staticmethod
    def from_factors(horizontal: int, vertical: int) -> Optional["SamplingFactor"]:
        """Reference encoder.rs:157-171."""
        table = {
            (1, 1): SamplingFactor.F_1_1,
            (1, 2): SamplingFactor.F_1_2,
            (1, 4): SamplingFactor.F_1_4,
            (2, 1): SamplingFactor.F_2_1,
            (2, 2): SamplingFactor.F_2_2,
            (2, 4): SamplingFactor.F_2_4,
            (4, 1): SamplingFactor.F_4_1,
            (4, 2): SamplingFactor.F_4_2,
        }
        return table.get((horizontal, vertical))

    def get_sampling_factors(self) -> Tuple[int, int]:
        """Reference encoder.rs:173-176."""
        value = self.value
        return (value >> 4) & 0x07, value & 0x0F

    def supports_interleaved(self) -> bool:
        """Interleaved MCU mode only supports h/v factors of 1 or 2
        (reference encoder.rs:178-187)."""
        h, v = self.get_sampling_factors()
        return h in (1, 2) and v in (1, 2)


class QuantizationTableType:
    """Named quantization-table presets (reference quantization.rs:8-40).

    Each constant is the preset key accepted by
    ``Encoder.set_quantization_tables``; ``Custom(values)`` wraps a user
    table of 64 entries (clamped to 1..2048 like the reference).
    """

    Default = "default"
    Flat = "flat"
    CustomMsSsim = "custom_ms_ssim"
    CustomPsnrHvs = "custom_psnr_hvs"
    ImageMagick = "image_magick"
    KleinSilversteinCarney = "klein_silverstein_carney"
    DentalXRays = "dental_x_rays"
    VisualDetectionModel = "visual_detection_model"
    ImprovedDetectionModel = "improved_detection_model"

    @staticmethod
    def Custom(values) -> Tuple[int, ...]:
        values = tuple(int(v) for v in values)
        if len(values) != 64:
            raise ValueError("custom quantization table must have 64 entries")
        return values


class PixelDensityUnit(enum.Enum):
    """Reference writer.rs:48-59."""

    PIXEL_ASPECT_RATIO = 0
    INCHES = 1
    CENTIMETERS = 2


@dataclass(frozen=True)
class PixelDensity:
    """JFIF APP0 density (reference writer.rs:16-45)."""

    density: Tuple[int, int] = (1, 1)
    unit: PixelDensityUnit = PixelDensityUnit.PIXEL_ASPECT_RATIO

    @staticmethod
    def dpi(density: int) -> "PixelDensity":
        return PixelDensity(density=(density, density), unit=PixelDensityUnit.INCHES)


@dataclass(frozen=True)
class Component:
    """Per-JPEG-component descriptor (reference encoder.rs:190-210)."""

    id: int
    quantization_table: int
    dc_huffman_table: int
    ac_huffman_table: int
    horizontal_sampling_factor: int
    vertical_sampling_factor: int


def init_components(
    color: JpegColorType, sampling_factor: SamplingFactor
) -> Tuple[Component, ...]:
    """Component table per colorspace, replicating the reference's mapping
    quirks (encoder.rs:569-619):

    * Ycbcr: Y on tables 0 carrying the sampling factor; Cb/Cr on tables 1 at
      1x1.
    * Cmyk:  C/M/Y on tables **1** at 1x1 and K on tables **0** carrying the
      sampling factor.
    * Ycck:  Y and K both on tables 0 with the sampling factor; Cb/Cr on
      tables 1.
    """
    h, v = sampling_factor.get_sampling_factors()

    def comp(cid: int, dest: int, ch: int, cv: int) -> Component:
        return Component(
            id=cid,
            quantization_table=dest,
            dc_huffman_table=dest,
            ac_huffman_table=dest,
            horizontal_sampling_factor=ch,
            vertical_sampling_factor=cv,
        )

    if color is JpegColorType.LUMA:
        return (comp(0, 0, 1, 1),)
    if color is JpegColorType.YCBCR:
        return (comp(0, 0, h, v), comp(1, 1, 1, 1), comp(2, 1, 1, 1))
    if color is JpegColorType.CMYK:
        return (
            comp(0, 1, 1, 1),
            comp(1, 1, 1, 1),
            comp(2, 1, 1, 1),
            comp(3, 0, h, v),
        )
    if color is JpegColorType.YCCK:
        return (
            comp(0, 0, h, v),
            comp(1, 1, 1, 1),
            comp(2, 1, 1, 1),
            comp(3, 0, h, v),
        )
    raise ValueError(f"unknown color type: {color}")


def max_sampling(components: Tuple[Component, ...]) -> Tuple[int, int]:
    """Reference encoder.rs:621-631."""
    max_h = max(c.horizontal_sampling_factor for c in components)
    max_v = max(c.vertical_sampling_factor for c in components)
    return max_h, max_v


@dataclass(frozen=True)
class EncoderConfig:
    """Frozen, hashable snapshot of the full encoder configuration.

    Mirrors every setter on the reference ``Encoder`` (encoder.rs:277-435)
    1:1, so it can ride through jit as a static argument.  ``quantization``
    holds either preset names (str) or custom 64-entry tuples.
    """

    quality: int = 90
    sampling_factor: SamplingFactor = SamplingFactor.F_1_1
    # (luma, chroma); each is a preset name or a tuple of 64 ints (Custom).
    quantization: Tuple[object, object] = ("default", "default")
    progressive_scans: Optional[int] = None
    restart_interval: Optional[int] = None
    optimize_huffman_table: bool = False
    density: PixelDensity = field(default_factory=PixelDensity)

    def __post_init__(self):
        if self.progressive_scans is not None and not (
            2 <= self.progressive_scans <= 64
        ):
            raise ValueError(
                f"Invalid number of scans: {self.progressive_scans}"
            )

    def mode(self) -> str:
        """Mode dispatch, replicating encoder.rs:556-562."""
        if self.progressive_scans is not None:
            return "progressive"
        if self.optimize_huffman_table or not self.sampling_factor.supports_interleaved():
            return "sequential"
        return "interleaved"
