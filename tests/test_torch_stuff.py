"""tpuenc_torch's device finish (``entropy.device_stuff``) against
``tpuenc``'s (JAX on the CPU), the port's host finish (the native
realigner) and the frozen fixtures, byte for byte (tolerance 0: integer
arithmetic throughout).

The port sizes its passes from the segment bit counts, so it has no
overflow case: a stream past ``tpuenc``'s slack, which ``tpuenc`` hands
back to the host finish, comes out of the port's passes themselves.  The
whole-image routes and the single-program batch finish on the device;
the host finish (``_finish_scans_v2``), on no route, is these tests'
reference, and the chunked paths keep the streaming stuffer."""

from __future__ import annotations

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import tpuenc  # noqa: E402
import tpuenc_torch as tt  # noqa: E402
from tpuenc.entropy import device_stuff as jds  # noqa: E402
from tpuenc_torch import plan as planning  # noqa: E402
from tpuenc_torch.entropy import device_encode as tde  # noqa: E402
from tpuenc_torch.entropy import device_stuff as tds  # noqa: E402
from tpuenc_torch.entropy import native  # noqa: E402
from tpuenc_torch.testing.fixtures import build_cases, img  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def _stream(seed, structure, mod8=None, ff=0.0, tail_ones=False, slack=0,
            empty=0.0):
    """Random stream words (uint32) and unpadded segment bit counts for a
    plan of ``structure`` segments per scan: bit counts ``mod8`` (mod 8)
    where given, a share ``ff`` of all-ones words, the bits after the last
    segment set (``tail_ones``), ``slack`` spare zero words, and a share
    ``empty`` of segments with no bits."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(9, 400, sum(structure)).astype(np.int64)
    if mod8 is not None:
        bits += mod8 - bits % 8
    bits[rng.random(bits.size) < empty] = 0
    n = (int(bits.sum()) + 31) >> 5
    words = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    words[rng.random(n) < ff] = 0xFFFFFFFF
    if tail_ones:
        used = int(bits.sum()) & 31
        words[-1] |= np.uint32((1 << (32 - used)) - 1 if used else 0)
    return np.concatenate([words, np.zeros(slack, np.uint32)]), bits


def _port(words, bits, structure):
    out, seg_out, total = tds.device_stuff(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(bits),
        structure, bits)
    total = int(total)
    return out[:total].numpy().tobytes(), seg_out.numpy(), total


def _host(words, bits, structure):
    """The native host finish of every scan, in plan order."""
    data = words.byteswap().tobytes()
    out, s = b"", 0
    for n in structure:
        out += native.realign_segments(data, bits[s:s + n],
                                       bit_offset=int(bits[:s].sum()))
        s += n
    return out


STREAMS = {
    "one_segment": ([1], {}),
    "one_scan_13_segments": ([13], {}),  # RST m wraps past 7
    "one_scan_20_segments": ([20], {"mod8": 3}),
    "three_scans": ([3, 11, 2], {}),  # m restarts at each scan
    "bits_0_mod_8": ([4, 9], {"mod8": 0}),
    "bits_1_mod_8": ([4, 9], {"mod8": 1}),
    "tail_ones": ([2, 5], {"tail_ones": True}),
    "dense_ff": ([6, 10], {"ff": 0.2}),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_device_stuff_matches_tpuenc(name):
    """The port's passes equal tpuenc's (out[:total], seg_out_bytes and
    total) and the native host finish.  Spare zero words give tpuenc's
    output, sized from the buffer, its slack."""
    structure, kw = STREAMS[name]
    words, bits = _stream(len(name), structure, slack=64, **kw)
    out, seg_out, total = _port(words, bits, structure)
    j_out, j_seg, j_total = jds.device_stuff(
        jnp.asarray(words), bits.astype(np.int32), structure)
    assert int(j_total) <= j_out.shape[0]  # within tpuenc's slack
    assert total == int(j_total)
    assert np.array_equal(seg_out, np.asarray(j_seg))
    assert out == np.asarray(j_out)[:total].tobytes()
    assert out == _host(words, bits, structure)


@pytest.mark.parametrize("window", [1, 5, 64, 1000])
def test_windows_give_the_same_bytes(window, monkeypatch):
    """The passes over windows of 1 byte up to the whole stream: segment
    ends, 0xFF runs and empty segments (which the packer never makes, and
    tpuenc's passes do not handle as the native realigner does) on and
    across window edges give the host finish's bytes (the 0xFF count
    carried on the device)."""
    structure = [4, 9, 3]
    words, bits = _stream(window, structure, ff=0.3, empty=0.2)
    want = _host(words, bits, structure)
    monkeypatch.setattr(tds, "_WINDOW", window)
    out, seg_out, total = _port(words, bits, structure)
    assert out == want and int(seg_out.sum()) == total == len(want)


@pytest.mark.parametrize("structure", [[1], [13], [3, 11, 2], [64, 1]])
def test_marker_plan_matches_tpuenc(structure):
    emit, ms = tds.marker_plan(structure)
    j_emit, j_ms = jds.marker_plan(structure)
    assert emit.dtype == j_emit.dtype and ms.dtype == j_ms.dtype
    assert np.array_equal(emit, j_emit) and np.array_equal(ms, j_ms)


def test_all_ff_stream_needs_no_fallback():
    """Every byte 0xFF: twice the realigned bytes plus the markers, past
    tpuenc's 1/4 slack (it would hand the stream back to the host); the
    port's passes give the host finish's bytes themselves."""
    structure = [5, 3]
    bits = np.array([800, 801, 8, 1031, 1600, 9, 16, 1072], np.int64)
    words = np.full((int(bits.sum()) + 31) >> 5, 0xFFFFFFFF, np.uint32)
    j_out, _, j_total = jds.device_stuff(jnp.asarray(words),
                                         bits.astype(np.int32), structure)
    assert int(j_total) > j_out.shape[0]
    out, seg_out, total = _port(words, bits, structure)
    n1 = int(((bits + 7) >> 3).sum())
    assert total == 2 * n1 + 2 * (len(bits) - len(structure))
    assert out == _host(words, bits, structure)
    assert int(seg_out.sum()) == total


def test_bad_segment_bits_raise():
    words = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="bits in a stream of 4 words"):
        tds.device_stuff(words, torch.tensor([100, 29]), [2], [100, 29])
    with pytest.raises(ValueError, match="plan of 3 segments"):
        tds.device_stuff(words, torch.tensor([8, 8]), [1, 2], [8, 8])
    with pytest.raises(ValueError, match="1-D int32"):
        tds.device_stuff(words.to(torch.int64), torch.tensor([8]), [1], [8])




@pytest.fixture
def finishes(monkeypatch):
    """Every run of the device finish, each checked against the host
    finish (``_finish_scans_v2``) on the same stream; the list of their
    scan counts."""
    calls = []
    device = tde._finish_scans_device

    def checked(buf, seg_bits, host_bits, segs, pinned=None):
        scans = device(buf, seg_bits, host_bits, segs, pinned)
        assert scans == tde._finish_scans_v2(buf, host_bits, segs)
        calls.append(len(segs))
        return scans

    monkeypatch.setattr(tde, "_finish_scans_device", checked)
    return calls


# tests/test_device_stuff.py's cases, set up on either package's Encoder.
def _sampling(e, name):
    return type(e.sampling_factor())[name]


ENCODES = {
    "plain_q95": (95, lambda e: None),
    "restart": (95, lambda e: e.set_restart_interval(4)),
    "restart_420": (95, lambda e: (
        e.set_sampling_factor(_sampling(e, "F_2_2")),
        e.set_restart_interval(3))),
    "progressive_restart": (95, lambda e: (
        e.set_progressive(True), e.set_restart_interval(5))),
    "sequential_4x1": (95, lambda e: e.set_sampling_factor(
        _sampling(e, "F_4_1"))),
    "optimized": (95, lambda e: e.set_optimized_huffman_tables(True)),
    "many_ff": (100, lambda e: e.set_restart_interval(2)),
}


def _pixels(name):
    if name == "many_ff":  # alternating extremes: 0xFF-dense codes
        px = np.zeros((48, 48, 3), np.uint8)
        px[::2] = 255
        px[:, ::2, 1] = 255
        return px
    return np.random.default_rng(31).integers(0, 256, (62, 70, 3), np.uint8)


@pytest.mark.parametrize("name", sorted(ENCODES))
def test_encode_matches_tpuenc_device_stuff(name, monkeypatch, finishes):
    """Whole files: the port, which finishes on the device, == tpuenc with
    TPUENC_DEVICE_STUFF=1; the host finish gives the same scans."""
    quality, setup = ENCODES[name]
    px = _pixels(name)
    h, w = px.shape[:2]
    monkeypatch.setenv("TPUENC_DEVICE_ENTROPY", "strict")
    monkeypatch.setenv("TPUENC_PACK", "v2")
    monkeypatch.setenv("TPUENC_DEVICE_STUFF", "1")
    ref = tpuenc.Encoder(quality)
    setup(ref)
    want = ref.encode(px.tobytes(), w, h, tpuenc.ColorType.RGB)
    assert ref.last_encode_path == "device-v2"

    e = tt.Encoder(quality, device="cpu")
    setup(e)
    assert e.encode(px, w, h, tt.ColorType.RGB) == want
    assert e.last_encode_path == "device-v2"
    assert len(finishes) == 1


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_fixtures_device_finish_equals_host_finish(fused, finishes):
    """All 26 fixtures, split and fused: each file is the frozen one, and
    the device finish gave the host finish's scans on its stream."""
    cases = build_cases("cpu", fused_p1=fused)
    assert len(cases) == 26
    for name, (build, ct, ch, seed, w, h) in cases.items():
        want = open(os.path.join(HERE, "fixtures", f"{name}.jpg"), "rb").read()
        enc = build()
        runs = len(finishes)
        assert enc.encode(img(ch, seed, w, h), w, h, ct) == want, name
        assert len(finishes) == runs + 1, name
        fused_route = fused and enc._config().mode() == "interleaved"
        assert enc.last_encode_path == (
            "device-v2-fused" if fused_route else "device-v2")


def _encoder(fused=False, restart=0, scans=None):
    e = tt.Encoder(90, device="cpu", fused_p1=fused)
    e.set_restart_interval(restart)
    if scans:
        e.set_progressive_scans(scans)
    return e


@pytest.mark.parametrize("kw,single,batch", [
    ({}, "device-v2", "device-batch"),
    ({"fused": True}, "device-v2-fused", "device-batch"),
    ({"restart": 7}, "device-v2", "device-batch-per-image"),
    ({"fused": True, "restart": 7}, "device-v2-fused",
     "device-batch-per-image"),
    ({"scans": 3}, "device-v2", "device-batch-per-image"),
])
def test_routes_and_their_finish(kw, single, batch, finishes):
    """encode and both of encode_batch's routes finish on the device: the
    per-image route once an image, the single program once for the whole
    batch, each image a scan; each batch file is encode's."""
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (24, 40, 3), np.uint8) for _ in range(2)]
    enc = _encoder(**kw)
    want = [enc.encode(im, 40, 24, tt.ColorType.RGB) for im in imgs]
    assert enc.last_encode_path == single
    assert len(finishes) == 2
    assert enc.encode_batch(imgs, 40, 24, tt.ColorType.RGB) == want
    assert enc.last_encode_path == batch
    assert finishes[2:] == ([2] if batch == "device-batch" else finishes[:2])


@pytest.mark.parametrize("scans,route", [
    (None, "device-chunked"), (3, "device-chunked-multipass")])
def test_chunked_paths_keep_the_host_finish(scans, route, monkeypatch,
                                            finishes):
    rng = np.random.default_rng(9)
    im = rng.integers(0, 256, (24, 40, 3), np.uint8)
    want = _encoder(scans=scans).encode(im, 40, 24, tt.ColorType.RGB)
    assert len(finishes) == 1
    monkeypatch.setattr(planning, "DEVICE_BLOCK_LIMIT", 0)
    enc = _encoder(scans=scans)
    assert enc.encode(im, 40, 24, tt.ColorType.RGB) == want
    assert enc.last_encode_path == route
    assert len(finishes) == 1
