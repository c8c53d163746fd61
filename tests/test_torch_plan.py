"""tpuenc_torch's plan on the CPU: each call decides its route and scan plan
once (``tpuenc_torch.plan.make_plan``) and hands them down, so that one
call, on any route, lays out its scans once, builds its scan plan once and
writes one frame header a file, and the single-program batch one for all
of its files.  The bytes are each route's own; the other tests hold them
against ``tpuenc``."""

from __future__ import annotations

import sys
from collections import Counter

import numpy as np
import pytest

import tpuenc_torch as tt
from tpuenc_torch import plan as planning
from tpuenc_torch.entropy import device_encode as de
from tpuenc_torch.jfif import segments
from tpuenc_torch.kernels import pipeline

W, H = 40, 24
RGB = tt.ColorType.RGB
IMGS = [np.random.default_rng(s).integers(0, 256, (H, W, 3), np.uint8)
        for s in range(3)]


def _encode(enc):
    return [enc.encode(IMGS[0], W, H, RGB)]


def _batch(enc):
    return enc.encode_batch(IMGS, W, H, RGB)


def _stream(enc):
    return [b"".join(enc.encode_stream(IMGS[0], W, H, RGB,
                                       chunk_mcu_rows=1))]


# name -> (encoder keywords, settings, whole-image limit, call, route,
# frame headers a call)
CASES = {
    "v2": ({}, {}, None, _encode, "device-v2", 1),
    "v2_fused": ({"fused_p1": True}, {}, None, _encode, "device-v2-fused", 1),
    "optimized": ({}, {"optimized_huffman_tables": True}, None, _encode,
                  "device-v2", 1),
    "chunked": ({}, {}, 0, _encode, "device-chunked", 1),
    "chunked_multipass": ({}, {"progressive": True}, 0, _encode,
                          "device-chunked-multipass", 1),
    "batch_single": ({}, {}, None, _batch, "device-batch", 1),
    # 4:4:4 40x24 has 15 MCUs, which restart interval 4 does not divide:
    # each image is encode()'s call, its frame header included.
    "batch_per_image": ({"fused_p1": True}, {"restart_interval": 4}, None,
                        _batch, "device-batch-per-image", 3),
    "stream": ({}, {}, None, _stream, "device-chunked-stream", 1),
    "stream_multipass": ({}, {"progressive": True}, None, _stream,
                         "device-v2", 1),
}


def _count_calls(monkeypatch, calls, owner, name):
    """Count the calls of ``owner.name`` through every binding of it in
    the port's loaded modules."""
    real = getattr(owner, name)

    def counted(*args, **kwargs):
        calls[name] += 1
        return real(*args, **kwargs)

    for module in list(sys.modules.values()):
        if getattr(module, "__name__", "").startswith("tpuenc_torch"):
            for key, value in list(vars(module).items()):
                if value is real:
                    monkeypatch.setattr(module, key, counted)


def _encoder(kw, settings):
    enc = tt.Encoder(90, device="cpu", **kw)
    for key, value in settings.items():
        getattr(enc, f"set_{key}")(value)
    return enc


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_plan_a_call(name, monkeypatch):
    kw, settings, limit, call, route, headers = CASES[name]
    if limit is not None:
        monkeypatch.setattr(planning, "DEVICE_BLOCK_LIMIT", limit)
    enc = _encoder(kw, settings)
    call(enc)  # the encoder's tables are on the device from here on
    calls = Counter()
    _count_calls(monkeypatch, calls, pipeline, "scan_layout")
    _count_calls(monkeypatch, calls, de, "build_scan_plan")
    _count_calls(monkeypatch, calls, segments, "sof")
    files = call(enc)
    assert enc.last_encode_path == route
    assert calls == {"scan_layout": 1, "build_scan_plan": 1, "sof": headers}
    monkeypatch.undo()
    plain = _encoder({}, settings)
    assert files == [plain.encode(px, W, H, RGB) for px in IMGS[:len(files)]]
