"""tpuenc_torch — the PyTorch + CUDA port of ``tpuenc`` for NVIDIA Hopper.

A second package beside ``tpuenc`` (the JAX reference, byte for byte):
the same ``Encoder`` API on an explicit PyTorch device, for interleaved,
sequential and progressive scans with default or two-pass optimized
Huffman tables.  On a CUDA device the coefficient stage (fDCT + zigzag +
quantize, K1), the two-pass symbol counts (K7) and the entropy packer
(P1-P4: K2, K6, K3-K5) run as hand-written CUDA kernels (``csrc/``, built
with nvcc at first use); on the CPU the same path runs their plain
PyTorch versions.  The host builds the optimized tables and finishes each
scan with the native library (``native/entropy.cpp``).

This package imports ``torch`` and never ``jax`` or ``tpuenc``.
"""

from .api import Encoder, ImageBuffer
from .core.errors import (
    AppSegmentTooLarge,
    BadImageData,
    DimensionsTooLarge,
    EncodingError,
    IccTooLarge,
    InvalidAppSegment,
    WriteError,
    ZeroImageDimensions,
)
from .core.tables import QUANT_PRESET_NAMES, ZIGZAG
from .core.types import (
    ColorType,
    JpegColorType,
    PixelDensity,
    PixelDensityUnit,
    QuantizationTableType,
    SamplingFactor,
)
from .entropy.device_encode import EncodeParams, params_from_numpy
from .kernels.fdct import fdct_blocks

__version__ = "0.1.0"

__all__ = [
    "Encoder",
    "ImageBuffer",
    "ColorType",
    "JpegColorType",
    "SamplingFactor",
    "PixelDensity",
    "PixelDensityUnit",
    "EncodingError",
    "InvalidAppSegment",
    "AppSegmentTooLarge",
    "IccTooLarge",
    "BadImageData",
    "DimensionsTooLarge",
    "ZeroImageDimensions",
    "WriteError",
    "QuantizationTableType",
    "QUANT_PRESET_NAMES",
    "ZIGZAG",
    "fdct_blocks",
    "rgb_to_ycbcr",
    "cmyk_to_ycck",
    "EncodeParams",
    "params_from_numpy",
]


def rgb_to_ycbcr(r: int, g: int, b: int):
    """Scalar exact fixed-point RGB->YCbCr (reference image_buffer.rs:9-31)."""
    y = 19595 * r + 38470 * g + 7471 * b
    cb = -11059 * r - 21709 * g + 32768 * b + (128 << 16)
    cr = 32768 * r - 27439 * g - 5329 * b + (128 << 16)
    return ((y + 0x7FFF) >> 16, (cb + 0x7FFF) >> 16, (cr + 0x7FFF) >> 16)


def cmyk_to_ycck(c: int, m: int, y: int, k: int):
    """Scalar CMYK->YCCK (reference image_buffer.rs:35-38)."""
    yy, cb, cr = rgb_to_ycbcr(c, m, y)
    return (yy, cb, cr, 255 - k)
