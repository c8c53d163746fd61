"""Color conversion + planarization, plain PyTorch.

Counterpart of ``tpuenc/kernels/color_convert.py``: the exact 2^16
fixed-point transform of the reference (image_buffer.rs:9-31), including
the ``+0x7FFF`` round, in int32, for all nine input color types.  Inputs
are 0..255 pixel values; outputs are int32 planes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.types import ColorType


def rgb_to_ycbcr(r, g, b):
    """Exact fixed-point RGB -> YCbCr (reference image_buffer.rs:9-31).

    Scaled by 2^16 with +0x7FFF rounding:
      Y  =  0.29900 R + 0.58700 G + 0.11400 B
      Cb = -0.16874 R - 0.33126 G + 0.50000 B + 128
      Cr =  0.50000 R - 0.41869 G - 0.08131 B + 128
    """
    r = r.to(torch.int32)
    g = g.to(torch.int32)
    b = b.to(torch.int32)

    y = 19595 * r + 38470 * g + 7471 * b
    cb = -11059 * r - 21709 * g + 32768 * b + (128 << 16)
    cr = 32768 * r - 27439 * g - 5329 * b + (128 << 16)

    # Arithmetic shift matches the reference's i32 >> 16.
    y = (y + 0x7FFF) >> 16
    cb = (cb + 0x7FFF) >> 16
    cr = (cr + 0x7FFF) >> 16
    return y, cb, cr


def cmyk_to_ycck(c, m, y, k):
    """CMYK -> YCCK: rgb_to_ycbcr on (c,m,y) plus inverted K
    (reference image_buffer.rs:35-38)."""
    yy, cb, cr = rgb_to_ycbcr(c, m, y)
    return yy, cb, cr, 255 - k.to(torch.int32)


def to_planes(pixels, color_type: ColorType, *,
              batched: bool = False) -> Tuple[torch.Tensor, ...]:
    """Convert an interleaved (H, W, C) uint8/int image tensor into
    per-component int32 planes in JPEG colorspace.  A LUMA image has no
    channel axis: (H, W).  ``batched``: the tensor has a leading image
    axis, (N, H, W, C) or LUMA (N, H, W), and so do the planes.  The
    caller states it; the number of axes is checked against it, never
    read as a channel axis (``tpuenc``'s batched-LUMA fault, a7d141e).

    Channel mappings follow the reference's nine ``ImageBuffer`` impls
    (image_buffer.rs:100-313):

    * RGB/RGBA/BGR/BGRA -> YCbCr via the fixed-point transform (alpha
      ignored).
    * CMYK is stored inverted (255-x on all four channels, Adobe
      convention, image_buffer.rs:250-255).
    * CMYK-as-YCCK converts the non-inverted C,M,Y through the RGB
      transform and inverts K (image_buffer.rs:274-285).
    * Luma/YCbCr/YCCK pass through.
    """
    ct = ColorType(color_type)
    ndim = 2 + int(batched) + int(ct is not ColorType.LUMA)
    if pixels.ndim != ndim:
        raise ValueError(f"{ct} pixels{' (batched)' if batched else ''} "
                         f"take {ndim} axes, got shape {tuple(pixels.shape)}")
    px = pixels.to(torch.int32)

    if ct is ColorType.LUMA:
        return (px,)

    c0, c1, c2 = px[..., 0], px[..., 1], px[..., 2]

    if ct in (ColorType.RGB, ColorType.RGBA):
        return rgb_to_ycbcr(c0, c1, c2)
    if ct in (ColorType.BGR, ColorType.BGRA):
        return rgb_to_ycbcr(c2, c1, c0)
    if ct is ColorType.YCBCR:
        return (c0, c1, c2)

    c3 = px[..., 3]
    if ct is ColorType.CMYK:
        return (255 - c0, 255 - c1, 255 - c2, 255 - c3)
    if ct is ColorType.CMYK_AS_YCCK:
        return cmyk_to_ycck(c0, c1, c2, c3)
    if ct is ColorType.YCCK:
        return (c0, c1, c2, c3)
    raise ValueError(f"unsupported color type: {color_type}")
