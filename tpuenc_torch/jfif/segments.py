"""JFIF segment assembly (cold path, pure byte strings).

Byte-exact re-implementation of the reference's segment writers
(``src/writer.rs:204-306, 390-452``): JFIF APP0 v1.02 with
density, Adobe APP14 transform flags, DQT in zigzag order with 8-bit
precision, DHT, SOF0/SOF2, SOS with spectral selection (successive
approximation byte always 0), and DRI.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence, Tuple

from ..core.tables import ZIGZAG, HuffmanTable, QuantizationTable
from ..core.types import Component, PixelDensity, PixelDensityUnit
from . import markers


def marker(code: int) -> bytes:
    return bytes((0xFF, code))


def segment(code: int, data: bytes) -> bytes:
    """Marker + 16-bit length (incl. the length field) + payload
    (reference writer.rs:208-214)."""
    return marker(code) + struct.pack(">H", len(data) + 2) + data


def app0_jfif(density: PixelDensity) -> bytes:
    """JFIF APP0 v1.02 header (reference writer.rs:216-239)."""
    unit = {
        PixelDensityUnit.PIXEL_ASPECT_RATIO: 0,
        PixelDensityUnit.INCHES: 1,
        PixelDensityUnit.CENTIMETERS: 2,
    }[density.unit]
    x, y = density.density
    data = b"JFIF\0" + bytes((0x01, 0x02, unit)) + struct.pack(">HH", x, y) + b"\0\0"
    return segment(markers.APP(0), data)


def app14_adobe(transform: int) -> bytes:
    """Adobe APP14 color-transform segment (reference encoder.rs:540-550):
    transform 0 = unknown (CMYK), 2 = YCCK."""
    return segment(markers.APP(14), b"Adobe\0\0\0\0\0\0" + bytes((transform,)))


def dqt(destination: int, table: QuantizationTable) -> bytes:
    """DQT, 8-bit precision, values in zigzag order
    (reference writer.rs:283-300)."""
    assert destination < 4
    vals = table.dqt_values()
    data = bytes((destination,)) + bytes(int(vals[z]) for z in ZIGZAG)
    return segment(markers.DQT, data)


def dht(coding_class: int, destination: int, table: HuffmanTable) -> bytes:
    """DHT: 4-bit class / 4-bit destination, 16 length counts, values
    (reference writer.rs:253-269)."""
    assert destination < 4
    data = (
        bytes(((coding_class << 4) | destination,))
        + bytes(table.lengths)
        + bytes(table.values)
    )
    return segment(markers.DHT, data)


def dri(restart_interval: int) -> bytes:
    """DRI (reference writer.rs:302-306)."""
    return marker(markers.DRI) + struct.pack(">HH", 4, restart_interval)


def sof(
    width: int,
    height: int,
    components: Sequence[Component],
    progressive: bool,
) -> bytes:
    """SOF0 (baseline) or SOF2 (progressive), 8-bit precision
    (reference writer.rs:390-422)."""
    code = markers.SOF_PROGRESSIVE_DCT if progressive else markers.SOF_BASELINE_DCT
    data = bytearray()
    data.append(8)
    data += struct.pack(">HH", height, width)
    data.append(len(components))
    for c in components:
        data.append(c.id)
        data.append((c.horizontal_sampling_factor << 4) | c.vertical_sampling_factor)
        data.append(c.quantization_table)
    return segment(code, bytes(data))


def sos(
    components: Sequence[Component],
    spectral: Optional[Tuple[int, int]] = None,
) -> bytes:
    """SOS header; spectral selection (Ss, Se) defaults to (0, 63);
    successive approximation byte always 0 (reference writer.rs:424-452)."""
    data = bytearray()
    data.append(len(components))
    for c in components:
        data.append(c.id)
        data.append((c.dc_huffman_table << 4) | c.ac_huffman_table)
    ss, se = spectral if spectral is not None else (0, 63)
    data += bytes((ss, se, 0))
    return segment(markers.SOS, bytes(data))
