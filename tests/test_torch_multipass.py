"""The chunked multipass route (``entropy.chunked_multipass``) against the
plain reference encoder (``encbench/reference/jpeg.py``, plain PyTorch),
byte for byte, on seeded random YCCK pages at q90 4:2:0 with two-pass
optimized tables: the route forced at a small size by lowering
``plan.DEVICE_BLOCK_LIMIT``, with several coefficient chunks, several pack
chunks, a height that is not whole MCUs and a partial last pack chunk;
its two passes and its store as the tracer sees them; and a q100 RGB
photo on the whole-image route, every quantizer 1."""

from __future__ import annotations

import functools
import os
import sys

import numpy as np
import pytest

import tpuenc_torch as tt
from tpuenc_torch import api
from tpuenc_torch import plan as planning
from tpuenc_torch import tracing
from tpuenc_torch.entropy import chunked_multipass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "encbench"))

from reference import jpeg  # noqa: E402

QUALITY = 90

# (width, height, coefficient chunk in MCU rows, pack chunk in blocks); an
# MCU is 16x16 pixels, Y and K code ceil(w/8) x ceil(h/8) blocks each, Cb
# and Cr ceil(w/16) x ceil(h/16)
CASES = {
    "coefficient-chunks": (64, 96, 2, 1 << 20),    # 6 MCU rows: 3 chunks
    "pack-chunks": (128, 128, 8, 128),             # Y, K: 256 = 2 x 128
    "height-not-whole-mcus": (72, 101, 3, 128),    # 7 MCU rows: 3, 3, 1
    "partial-last-pack-chunk": (120, 88, 2, 128),  # Y, K: 165 = 128 + 37
}


def page(w, h, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4), np.uint8)


@pytest.fixture
def multipass(monkeypatch):
    """Every encode past the whole-image limit, with the chunk sizes of
    the case handed to the route that ``Encoder.encode`` calls."""
    monkeypatch.setattr(planning, "DEVICE_BLOCK_LIMIT", 0)

    def sizes(chunk_mcu_rows, pack_chunk):
        monkeypatch.setattr(api, "encode_multipass_chunked", functools.partial(
            chunked_multipass.encode_multipass_chunked,
            chunk_mcu_rows=chunk_mcu_rows, pack_chunk=pack_chunk))
    return sizes


@pytest.fixture
def tracer():
    tracing.disable()
    try:
        yield tracing
    finally:
        tracing.disable()


def port(px, w, h):
    enc = tt.Encoder(QUALITY, device="cpu")
    enc.set_sampling_factor(tt.SamplingFactor.F_2_2)
    enc.set_optimized_huffman_tables(True)
    out = enc.encode(px, w, h, tt.ColorType.CMYK_AS_YCCK)
    assert enc.last_encode_path == "device-chunked-multipass"
    return out


def reference(px, const_bits=13):
    return jpeg.encode(px, color_type="cmyk_as_ycck", quality=QUALITY,
                       sampling=(2, 2), optimize_tables=True,
                       const_bits=const_bits)


@pytest.mark.parametrize("case", sorted(CASES))
def test_multipass_files_are_the_reference(multipass, case):
    w, h, rows, pack = CASES[case]
    multipass(rows, pack)
    px = page(w, h, w * h + rows)
    got = port(px, w, h)
    assert got == reference(px)
    assert got.count(b"\xff\xda") == 4  # Y, Cb, Cr, K: a scan each


def test_the_reference_in_lower_precision_differs(multipass):
    """The control: the reference's transform at 8 fractional bits is not
    the route's file."""
    w, h, rows, pack = CASES["partial-last-pack-chunk"]
    multipass(rows, pack)
    px = page(w, h, w * h + rows)
    assert port(px, w, h) != reference(px, const_bits=8)


def _ancestors(req, span):
    while span.parent is not None:
        span = req.spans[span.parent]
        yield span.name


def test_the_passes_and_the_store_as_traced(multipass, tracer):
    w, h, rows, pack = CASES["partial-last-pack-chunk"]
    multipass(rows, pack)
    px = page(w, h, 7)
    tracer.enable()
    got = port(px, w, h)
    (req,) = tracer.requests()
    (store,) = [s for s in req.spans if s.name == "multipass.store"]
    scans = [s for s in req.spans if s.name == "multipass.scan"]
    assert [s.ints["scan"] for s in scans] == [0, 1, 2, 3]
    assert store.end <= scans[0].start
    assert all(a.end <= b.start for a, b in zip(scans, scans[1:]))
    # the passes' stages inside them; the counts' read and the tables
    # between them
    for s in req.spans:
        up = list(_ancestors(req, s))
        if s.name in ("transform", "histograms"):
            assert up[0] == "multipass.store", s
        if s.name in ("pack", "finish.stream", "sync.meta", "sync.counts"):
            assert up[0] == "multipass.scan", s
        if s.name in ("sync.hist", "tables", "assemble"):
            assert up == ["encode"], s
    # Y and K 165 blocks, Cb and Cr 8 x 6 = 48, each padded to its pack
    # chunk of 128: 256 + 128 + 128 + 256 blocks of 128 bytes
    assert req.counters["store_bytes"] == 128 * (256 + 128 + 128 + 256)
    assert req.counters["restart_segments"] == 4
    tracer.disable()
    assert port(px, w, h) == got


def test_a_q100_photo_on_the_whole_image_route_is_the_reference():
    """Every quantizer 1 (4:4:4, the default at q100): the largest DC and
    AC categories and the densest stream a photo codes."""
    w, h = 48, 40
    px = np.random.default_rng(100).integers(0, 256, (h, w, 3), np.uint8)
    enc = tt.Encoder(100, device="cpu")
    got = enc.encode(px, w, h, tt.ColorType.RGB)
    assert enc.last_encode_path == "device-v2"
    assert got == jpeg.encode(px, color_type="rgb", quality=100)
