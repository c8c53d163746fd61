"""tpuenc_torch's file assembly on the CPU: every file is gathered in one
copy (``Encoder._assemble_scans``) from the parts that its route's finish
hands over, comes back as ``bytes`` that no later call of the same encoder
changes, and equals tpuenc's file byte for byte.

On a CUDA device the device finish copies its bytes into the encoder's
page-locked buffer and hands each scan over as a view of it, which the
next encode overwrites; :class:`ReusedBuffer` stands in for that buffer
here, one plain CPU tensor reused by every copy, so that the hazard is
exercised without a card."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")

import tpuenc  # noqa: E402
import tpuenc_torch as tt  # noqa: E402
from tpuenc_torch import plan as planning  # noqa: E402
from tpuenc_torch.entropy import device_encode as de  # noqa: E402

W, H = 40, 24


def _img(seed):
    return np.random.default_rng(seed).integers(0, 256, (H, W, 3), np.uint8)


A, B = _img(1), _img(2)


class ReusedBuffer(de.PinnedBuffer):
    """The encoder's page-locked buffer as the device finish uses it, on
    the CPU: every copy lands at the start of one plain tensor."""

    def __init__(self):
        super().__init__()
        self._buf = torch.empty(1 << 16, dtype=torch.uint8)
        self.takes = 0

    def take(self, n, dtype):
        self.takes += 1
        view = super().take(n, dtype)
        assert view.data_ptr() == self._buf.data_ptr(), "the buffer grew"
        return view


# name -> (settings, call(encoder, image) -> that image's file, route)
def _encode(enc, px):
    return enc.encode(px, W, H, tt.ColorType.RGB)


def _batch(enc, px):
    (out, _) = enc.encode_batch([px, px[::-1].copy()], W, H, tt.ColorType.RGB)
    return out


def _stream(enc, px):
    return enc.encode_stream(px, W, H, tt.ColorType.RGB)


ROUTES = {
    "encode": ({}, _encode, "device-v2"),
    "progressive": ({"progressive": True}, _encode, "device-v2"),
    "batch": ({}, _batch, "device-batch"),
    "chunked": ({}, _encode, "device-chunked"),
    "chunked-multipass": ({"progressive": True}, _encode,
                          "device-chunked-multipass"),
}


def _port(settings, buffer, monkeypatch):
    enc = tt.Encoder(90, device="cpu")
    for key, value in settings.items():
        getattr(enc, f"set_{key}")(value)
    if buffer is not None:
        monkeypatch.setattr(enc, "_pinned_buffer", lambda: buffer)
    return enc


def _tpuenc(settings, px):
    enc = tpuenc.Encoder(90)
    for key, value in settings.items():
        getattr(enc, f"set_{key}")(value)
    return enc.encode(px, W, H, tpuenc.ColorType.RGB)


@pytest.mark.parametrize("reuse", [False, True], ids=["fresh", "reused"])
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_a_file_is_bytes_that_the_next_encode_leaves_alone(name, reuse,
                                                           monkeypatch):
    settings, call, route = ROUTES[name]
    if route.startswith("device-chunked"):
        monkeypatch.setattr(planning, "DEVICE_BLOCK_LIMIT", 0)
    buffer = ReusedBuffer() if reuse else None
    enc = _port(settings, buffer, monkeypatch)
    a = call(enc, A)
    assert enc.last_encode_path == route
    assert type(a) is bytes
    kept = bytes(bytearray(a))
    b = call(enc, B)
    assert type(b) is bytes and b != a
    assert a == kept == _tpuenc(settings, A)
    assert b == _tpuenc(settings, B)
    if reuse and not route.startswith("device-chunked"):
        assert buffer.takes == 2  # both finishes copied into one buffer


@pytest.mark.parametrize("reuse", [False, True], ids=["fresh", "reused"])
def test_a_multipass_stream_keeps_its_scans_across_another_encode(
        reuse, monkeypatch):
    """The pieces of a progressive stream, with another encode of the same
    encoder between them, join to the stream's file."""
    settings = {"progressive": True}
    buffer = ReusedBuffer() if reuse else None
    enc = _port(settings, buffer, monkeypatch)
    pieces = _stream(enc, A)
    got = [next(pieces)]
    assert _encode(enc, B) == _tpuenc(settings, B)
    got += list(pieces)
    assert len(got) == 3 * 4 + 1 and all(type(p) is bytes for p in got)
    assert b"".join(got) == _tpuenc(settings, A)
    if reuse:
        assert buffer.takes == 2


# name -> the encoder's settings: one interleaved scan, 12 progressive
# scans, and one scan with a DRI and RST markers
PARTS = {
    "interleaved": {},
    "progressive12": {"progressive": True},
    "restart": {"restart_interval": 2},
}
_made = {}


def _made_for(name):
    """The encoder, its plan, the file's head and each scan's payload
    joined, once a case: the file that ``encode`` gives is the assembly
    of the route's own parts."""
    if name not in _made:
        enc = tt.Encoder(90, device="cpu")
        for key, value in PARTS[name].items():
            getattr(enc, f"set_{key}")(value)
        ct = tt.ColorType.RGB
        plan = enc._plan(W, H, ct)
        q_tables, huffman, params = enc._default_tables(plan.config)
        scans = enc._scan_payloads(A, plan, huffman, params)
        joined = [b"".join(parts) for parts in scans]
        head = enc._head(plan, q_tables, huffman)
        want = enc._assemble_scans(plan, head, [[s] for s in joined])
        assert want == enc.encode(A, W, H, ct) == _tpuenc(PARTS[name], A)
        _made[name] = (enc, plan, head, joined, want)
    return _made[name]


def _as(kind, data: bytes):
    if kind == "bytes":
        return data
    if kind == "bytearray":
        return bytearray(data)
    if kind == "memoryview":
        return memoryview(bytearray(b"\0" + data + b"\0"))[1:-1]
    return np.frombuffer(b"\0" + data, np.uint8)[1:]  # a numpy slice


KINDS = ["bytes", "bytearray", "memoryview", "numpy"]


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.data())
@pytest.mark.parametrize("name", sorted(PARTS))
def test_any_split_of_the_payloads_gives_the_same_file(name, data):
    enc, plan, head, joined, want = _made_for(name)
    if name == "progressive12":
        assert len(joined) == 12
    if name == "restart":
        assert b"\xff\xdd" in want and b"\xff\xd0" in b"".join(joined)
    payloads = []
    for scan in joined:
        cuts = sorted(data.draw(st.lists(
            st.integers(0, len(scan)), max_size=6)))
        bounds = [0, *cuts, len(scan)]
        payloads.append([_as(data.draw(st.sampled_from(KINDS)), scan[a:b])
                         for a, b in zip(bounds, bounds[1:])])
    head = _as(data.draw(st.sampled_from(["bytes", "bytearray"])), head)
    got = enc._assemble_scans(plan, head, payloads)
    assert type(got) is bytes and got == want
