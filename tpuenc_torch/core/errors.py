"""Error types for the JPEG encode engine.

Mirrors the reference's typed error surface (``src/error.rs:6-28``):
InvalidAppSegment, AppSegmentTooLarge, IccTooLarge, BadImageData,
ZeroImageDimensions, IoError/Write.  We keep fail-fast, per-image error
propagation; there is no partial output on error.
"""

from __future__ import annotations


class EncodingError(Exception):
    """Base class for all encode-time errors (reference: error.rs:6)."""


class InvalidAppSegment(EncodingError):
    """An invalid app segment number has been used (must be 1..=15)."""

    def __init__(self, segment_nr: int):
        self.segment_nr = segment_nr
        super().__init__(f"Invalid app segment number: {segment_nr}")


class AppSegmentTooLarge(EncodingError):
    """App segment exceeds maximum allowed data length (65533 bytes)."""

    def __init__(self, length: int):
        self.length = length
        super().__init__(
            f"App segment exceeds maximum allowed data length of 65533: {length}"
        )


class IccTooLarge(EncodingError):
    """ICC profile exceeds the maximum length embeddable in APP2 chunks."""

    def __init__(self, length: int):
        self.length = length
        super().__init__(
            f"ICC profile exceeds maximum allowed data length: {length}"
        )


class BadImageData(EncodingError):
    """Supplied pixel buffer is too short for width*height*bytes_per_pixel."""

    def __init__(self, length: int, required: int):
        self.length = length
        self.required = required
        super().__init__(
            "Image data too small for dimensions and color_type: "
            f"{length} need at least {required}"
        )


class ZeroImageDimensions(EncodingError):
    """Width or height is zero."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        super().__init__(f"Image dimensions must be non zero: {width}x{height}")


class DimensionsTooLarge(EncodingError):
    """Width or height exceeds the JPEG maximum of 65535.

    The reference cannot express this state (dimensions are typed ``u16``,
    ``encoder.rs:443-446``); here it is a runtime check so the SOF writer
    never emits truncated fields."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        super().__init__(
            f"Image dimensions exceed JPEG maximum of 65535: {width}x{height}"
        )


class WriteError(EncodingError):
    """An io error occurred during writing (reference error.rs:31-35 maps
    ``std::io::Error`` into the typed surface the same way)."""
