"""Restart intervals on the port's whole-image path against the plain
reference encoder (``encbench/reference/jpeg.py``, plain PyTorch), byte
for byte, on seeded random frames at q80 4:2:0: the DRI segment, a DC
reset at each segment, RST0-RST7 in turn between segments, a ragged last
segment, one MCU a segment, one segment for a whole scan, and frames that
are not whole MCUs.  The reference with its transform at 8 fractional
bits gives other bytes, so the comparison can fail."""

from __future__ import annotations

import math
import os
import re
import struct
import sys

import numpy as np
import pytest

import tpuenc_torch as tt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "encbench"))

from reference import jpeg  # noqa: E402

QUALITY = 80

# (width, height, restart interval): the frame's MCUs are 16x16 pixels
CASES = {
    "ragged-last-segment": (258, 172, 64),    # 17 x 11 = 187 MCUs: 64, 64, 59
    "interval-1": (64, 48, 1),                # 12 MCUs, 12 segments
    "interval-past-the-mcus": (64, 48, 100),  # 12 MCUs, one segment
    "not-whole-mcus": (77, 53, 3),            # 5 x 4 = 20 MCUs: 7 segments
    "strip-divides": (1024, 64, 64),          # 64 x 4 = 256 MCUs: 4 segments
}


def frame(w, h, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def port(px, w, h, interval):
    enc = tt.Encoder(QUALITY, device="cpu")
    enc.set_sampling_factor(tt.SamplingFactor.from_factors(2, 2))
    enc.set_restart_interval(interval)
    out = enc.encode(px, w, h, tt.ColorType.RGB)
    assert enc.last_encode_path == "device-v2"
    return out


def reference(px, interval, const_bits=13):
    return jpeg.encode(px, color_type="rgb", quality=QUALITY, sampling=(2, 2),
                       restart_interval=interval, const_bits=const_bits)


def restart_numbers(jpeg_bytes: bytes):
    """The RST markers' numbers in the file's one scan, in order: inside
    entropy-coded data a 0xFF is followed by a stuffed 0x00 or a marker."""
    (sos,) = [m.start() for m in re.finditer(b"\xff\xda", jpeg_bytes)]
    start = sos + 2 + struct.unpack(">H", jpeg_bytes[sos + 2:sos + 4])[0]
    assert jpeg_bytes.endswith(b"\xff\xd9")
    data = jpeg_bytes[start:-2]
    assert re.fullmatch(rb"(?:[^\xff]|\xff[\x00\xd0-\xd7])*", data, re.S)
    return [m[1] - 0xD0 for m in re.findall(rb"\xff[\xd0-\xd7]", data)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_restart_files_are_the_reference(case):
    w, h, interval = CASES[case]
    px = frame(w, h, w * h + interval)
    got = port(px, w, h, interval)
    assert got == reference(px, interval)
    assert got.count(b"\xff\xdd\x00\x04" + struct.pack(">H", interval)) == 1
    mcus = math.ceil(w / 16) * math.ceil(h / 16)
    n = math.ceil(mcus / interval) - 1
    assert restart_numbers(got) == [i % 8 for i in range(n)]


def test_the_reference_in_lower_precision_differs():
    """The control: the reference's transform at 8 fractional bits is not
    the port's file, so a wrong transform fails the comparison."""
    w, h, interval = CASES["ragged-last-segment"]
    px = frame(w, h, w * h + interval)
    low = reference(px, interval, const_bits=8)
    assert port(px, w, h, interval) != low
    assert len(restart_numbers(low)) == 2  # the same segments, other bits
