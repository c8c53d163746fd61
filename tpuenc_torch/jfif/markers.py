"""JPEG marker codes (ITU T.81 Table B.1).

Mirrors the reference marker enum (``src/marker.rs``)
including the full SOF family.
"""

from __future__ import annotations

SOI = 0xD8
EOI = 0xD9
SOS = 0xDA
DQT = 0xDB
DNL = 0xDC
DRI = 0xDD
DHP = 0xDE
EXP = 0xDF
DHT = 0xC4
DAC = 0xCC
COM = 0xFE
TEM = 0x01

# SOF types (marker.rs:47-75)
SOF_BASELINE_DCT = 0xC0
SOF_EXTENDED_SEQUENTIAL_DCT = 0xC1
SOF_PROGRESSIVE_DCT = 0xC2
SOF_LOSSLESS = 0xC3
SOF_DIFFERENTIAL_SEQUENTIAL_DCT = 0xC5
SOF_DIFFERENTIAL_PROGRESSIVE_DCT = 0xC6
SOF_DIFFERENTIAL_LOSSLESS = 0xC7
SOF_EXTENDED_SEQUENTIAL_DCT_ARITHMETIC = 0xC9
SOF_PROGRESSIVE_DCT_ARITHMETIC = 0xCA
SOF_LOSSLESS_ARITHMETIC = 0xCB
SOF_DIFFERENTIAL_SEQUENTIAL_DCT_ARITHMETIC = 0xCD
SOF_DIFFERENTIAL_PROGRESSIVE_DCT_ARITHMETIC = 0xCE
SOF_DIFFERENTIAL_LOSSLESS_ARITHMETIC = 0xCF


def RST(m: int) -> int:
    """Restart marker with modulo-8 count m."""
    return 0xD0 + (m & 7)


def APP(n: int) -> int:
    """Application segment marker APPn."""
    return 0xE0 + n


def JPGn(n: int) -> int:
    return 0xF0 + n
