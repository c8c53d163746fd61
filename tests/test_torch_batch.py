"""tpuenc_torch's ``encode_batch`` against tpuenc's and against per-image
``encode``, on the CPU (the kernels' plain versions), byte for byte
(integer arithmetic throughout: tolerance 0)."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")

import tpuenc  # noqa: E402
import tpuenc_torch as tt  # noqa: E402
from tpuenc_torch.core.types import EncoderConfig, SamplingFactor  # noqa: E402
from tpuenc_torch.entropy import device_encode as de  # noqa: E402
from tpuenc_torch.kernels import pipeline as tpipe  # noqa: E402
from tpuenc_torch.kernels.color_convert import to_planes  # noqa: E402
from tpuenc_torch.plan import (  # noqa: E402
    PER_IMAGE,
    SINGLE_PROGRAM,
    make_plan,
)


def _setup(enc, restart=0, scans=None, opt=False):
    if restart:
        enc.set_restart_interval(restart)
    if scans:
        enc.set_progressive_scans(scans)
    if opt:
        enc.set_optimized_huffman_tables(True)
    return enc


def _images(n, w, h, ch, seed):
    rng = np.random.default_rng(seed)
    shape = (h, w) if ch == 1 else (h, w, ch)
    return [rng.integers(0, 256, shape, np.uint8) for _ in range(n)]


# (n, w, h, color type, channels, quality, settings, route)
CASES = {
    # Twin of tests/test_device_entropy.py::test_fused_batch_matches_singles:
    # 4:2:0 at q85 has 15 MCUs, which restart interval 4 does not divide.
    "rgb66x34_restart0": (3, 66, 34, "RGB", 3, 85, {}, "device-batch"),
    "rgb66x34_restart4": (3, 66, 34, "RGB", 3, 85, {"restart": 4},
                          "device-batch-per-image"),
    # Twin of tests/test_api.py::test_encode_batch_luma_matches_singles:
    # batched LUMA is (N, H, W), no channel axis.
    "luma1x1_n2": (2, 1, 1, "LUMA", 1, 80, {}, "device-batch"),
    "luma16x16_n3": (3, 16, 16, "LUMA", 1, 80, {}, "device-batch"),
    # One image: with its W taken for channels the shapes still fit, and
    # the file came out wrong from byte 397 on.
    "luma16x16_n1": (1, 16, 16, "LUMA", 1, 80, {}, "device-batch"),
    "ycck": (3, 30, 20, "YCCK", 4, 90, {}, "device-batch"),
    "rgb420_q80_restart5": (3, 66, 34, "RGB", 3, 80, {"restart": 5},
                            "device-batch"),
    # 4:4:4 66x34 has 45 MCUs: interval 7 leaves a ragged last segment.
    "ragged_restart7": (3, 66, 34, "RGB", 3, 90, {"restart": 7},
                        "device-batch-per-image"),
    "progressive4_restart2": (3, 40, 24, "RGB", 3, 90,
                              {"scans": 4, "restart": 2},
                              "device-batch-per-image"),
    "optimized": (3, 40, 24, "RGB", 3, 90, {"opt": True},
                  "device-batch-per-image"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_batch_matches_tpuenc_and_singles(name):
    """Each route's files equal tpuenc's encode_batch and the port's own
    per-image encode, byte for byte, and the route is the expected one."""
    n, w, h, ct, ch, q, kw, route = CASES[name]
    imgs = _images(n, w, h, ch, seed=len(name))
    enc = _setup(tt.Encoder(q, device="cpu"), **kw)
    got = enc.encode_batch(imgs, w, h, tt.ColorType[ct])
    assert enc.last_encode_path == route
    assert enc.last_budget in de.BUDGET_LADDER
    want = _setup(tpuenc.Encoder(q), **kw).encode_batch(
        imgs, w, h, tpuenc.ColorType[ct])
    singles = [_setup(tt.Encoder(q, device="cpu"), **kw).encode(
        im, w, h, tt.ColorType[ct]) for im in imgs]
    assert got == want
    assert got == singles


def _restarts(scan):
    """The numbers of the RST markers in one scan's finished bytes, in
    order (a stuffed 0xFF is followed by 0x00, a marker's by 0xD0-0xD7)."""
    b = np.frombuffer(scan, np.uint8)
    at = np.flatnonzero((b[:-1] == 0xFF) & (b[1:] >= 0xD0) & (b[1:] <= 0xD7))
    return (b[at + 1] - 0xD0).tolist()


def _ff_images(n, w, h):
    """Alternating extremes, 0xFF-dense codes at q100, shifted a column
    further in each image."""
    px = np.zeros((h, w, 3), np.uint8)
    px[::2] = 255
    px[:, ::2, 1] = 255
    return [np.roll(px, i, axis=1) for i in range(n)]


# name: (n, w, h, quality, sampling factor, restart interval, content,
# the device finish's window in realigned bytes, None for its own)
FINISH_CASES = {
    "no_restart": (3, 66, 34, 90, "F_1_1", 0, "noise", None),
    # 48 MCUs an image: 12 segments, markers RST0-RST7, RST0-RST2.
    "restart_divides": (3, 64, 48, 90, "F_1_1", 4, "noise", None),
    # 4:2:0, 15 MCUs an image: 5 segments.
    "sf420_restart3": (3, 80, 48, 85, "F_2_2", 3, "noise", None),
    # 32 segments an image, the finish over many windows.
    "windows": (4, 64, 64, 100, "F_1_1", 2, "ff", 1024),
}


@pytest.mark.parametrize("name", sorted(FINISH_CASES))
def test_single_program_finishes_on_the_device(name, monkeypatch):
    """The single program's one device finish over every image of the
    batch, each image a scan of its segments: the files are tpuenc's
    encode_batch's, byte for byte; the images' finished bytes are the host
    finish's (``_finish_scans_v2``) on the same stream; each image's RST
    markers count from 0, and none follows an image's last segment.  With
    the finish's window cut to a few KiB, the finish crosses many windows;
    then it runs again on the same stream with its window edges on an
    image boundary, on a segment boundary and inside a run of 0xFF
    bytes."""
    from tpuenc_torch.entropy import device_stuff as ds

    n, w, h, q, sf, restart, content, window = FINISH_CASES[name]
    imgs = (_ff_images(n, w, h) if content == "ff"
            else _images(n, w, h, 3, seed=len(name)))
    if window:
        monkeypatch.setattr(ds, "_WINDOW", window)
    seen = []
    finish = de._finish_scans_device

    def recorded(buf, seg_bits, host_bits, segs, pinned=None):
        scans = finish(buf, seg_bits, host_bits, segs, pinned)
        seen.append((buf, seg_bits, host_bits, segs, scans))
        return scans

    monkeypatch.setattr(de, "_finish_scans_device", recorded)

    def setup(enc):
        enc.set_sampling_factor(type(enc.sampling_factor())[sf])
        enc.set_restart_interval(restart)
        return enc

    enc = setup(tt.Encoder(q, device="cpu"))
    got = enc.encode_batch(imgs, w, h, tt.ColorType.RGB)
    assert enc.last_encode_path == "device-batch"
    assert got == setup(tpuenc.Encoder(q)).encode_batch(
        imgs, w, h, tpuenc.ColorType.RGB)
    ((buf, seg_bits, host_bits, segs, scans),) = seen
    per = segs[0]
    assert segs == [per] * n and len(host_bits) == n * per
    assert (per > 1) == bool(restart)
    assert scans == de._finish_scans_v2(buf, host_bits, segs)
    for scan in scans:
        assert _restarts(scan) == [i % 8 for i in range(per - 1)]
    if not window:
        return
    nbytes, byte_start, src_off, end_bit = ds.segment_tables(seg_bits)
    n1 = int(nbytes.sum())
    assert n1 > 8 * window
    # The stream with a run of 0xFF bytes in it: 32 bytes of ones written
    # over the middle of its words.
    ones = buf.clone()
    ones[int(host_bits.sum()) >> 6:][:8] = -1
    aligned = ds.realign(ones, byte_start, src_off, end_bit, 0, n1)[0]
    in_run = np.flatnonzero((aligned[:-1] == 0xFF) & (aligned[1:] == 0xFF))
    starts = byte_start.numpy()
    # A window of e bytes puts an edge at e: realigned byte e starts a
    # window, and e - 1 ends the one before.
    edges = {"image": (buf, starts[per]), "segment": (buf, starts[3]),
             "0xFF run": (ones, in_run[len(in_run) // 2] + 1)}
    for where, (words, edge) in edges.items():
        monkeypatch.setattr(ds, "_WINDOW", int(edge))
        assert finish(words, seg_bits, host_bits, segs) == \
            de._finish_scans_v2(words, host_bits, segs), where


@pytest.mark.parametrize("restart,route", [
    (0, "device-batch"),                           # one program, K1 + K2
    (7, "device-batch-per-image"),                 # per image through K8
])
def test_fused_p1_routes(restart, route):
    """With fused_p1 the per-image route packs each interleaved image with
    K8 and the single program keeps K1 + K2, as in tpuenc; the files are
    the split encoder's either way."""
    imgs = _images(3, 66, 34, 3, seed=restart)
    enc = _setup(tt.Encoder(90, device="cpu", fused_p1=True), restart=restart)
    got = enc.encode_batch(imgs, 66, 34, tt.ColorType.RGB)
    assert enc.last_encode_path == route
    split = [_setup(tt.Encoder(90, device="cpu"), restart=restart).encode(
        im, 66, 34, tt.ColorType.RGB) for im in imgs]
    assert got == split


@pytest.mark.parametrize("kw", [{}, {"restart": 7}, {"scans": 2}],
                         ids=["single", "per_image", "per_image_progressive"])
def test_overflow_climbs_without_changing_bytes(kw):
    """A q100 batch whose noisy images overflow the ladder's first rung
    between flat ones that do not: the single program climbs its own
    ladder, the per-image route each image's; the files are the per-image
    encodes', and the memo keys are the batch's (with its size) and
    encode()'s."""
    rng = np.random.default_rng(5)
    flat = np.full((34, 66, 3), 128, np.uint8)
    imgs = [flat, rng.integers(0, 256, (34, 66, 3), np.uint8), flat]
    de._budget_memo.clear()
    enc = _setup(tt.Encoder(100, device="cpu"), **kw)
    got = enc.encode_batch(imgs, 66, 34, tt.ColorType.RGB)
    assert enc.last_budget > de.BUDGET_LADDER[0]
    singles = [_setup(tt.Encoder(100, device="cpu"), **kw).encode(
        im, 66, 34, tt.ColorType.RGB) for im in imgs]
    assert got == singles
    single = enc.last_encode_path == "device-batch"
    assert [len(k) for k in de._budget_memo] == ([7, 5] if single else [5])
    # A second batch starts at the learned rung: same bytes again.
    assert enc.encode_batch(imgs, 66, 34, tt.ColorType.RGB) == singles


def test_writer_sink_fed_once_per_image():
    """Twin of tests/test_api.py::test_encode_batch_honors_writer_sink."""
    imgs = _images(3, 16, 24, 3, seed=7)

    class Sink:
        def __init__(self):
            self.chunks = []

        def write(self, b):
            self.chunks.append(bytes(b))

    sink = Sink()
    enc = tt.Encoder.new_writer(sink, 90, device="cpu")
    outs = enc.encode_batch([i.tobytes() for i in imgs], 16, 24,
                            tt.ColorType.RGB)
    assert sink.chunks == outs
    assert outs == tpuenc.Encoder(90).encode_batch(
        [i.tobytes() for i in imgs], 16, 24, tpuenc.ColorType.RGB)


def test_bad_input_raises():
    enc = tt.Encoder(90, device="cpu")
    good = bytes(16 * 16 * 3)
    with pytest.raises(tt.BadImageData):
        enc.encode_batch([good, good[:-1]], 16, 16, tt.ColorType.RGB)
    with pytest.raises(tt.ZeroImageDimensions):
        enc.encode_batch([good], 0, 16, tt.ColorType.RGB)
    assert enc.encode_batch([], 16, 16, tt.ColorType.RGB) == []
    assert tpuenc.Encoder(90).encode_batch([], 16, 16,
                                           tpuenc.ColorType.RGB) == []


def test_over_limit_batch_raises_naming_m9(monkeypatch):
    """A batch of images past the whole-image limits goes image by image,
    each through encode's chunked path, as tpuenc's batch does (12.6M pack
    rows for 2048x2048 RGB in 64 scans; a small batch with the block limit
    forced down)."""
    from tpuenc_torch import plan as planning

    enc = tt.Encoder(90, device="cpu")
    enc.set_progressive_scans(64)
    plan = enc._plan(2048, 2048, tt.ColorType.RGB, n=2)
    assert plan.pack_rows > planning.DEVICE_PACK_ROWS_LIMIT
    assert (plan.route, plan.image_route) == (
        "device-batch-per-image", "device-chunked-multipass")

    imgs = _images(2, 40, 24, 3, 5)
    monkeypatch.setattr(planning, "DEVICE_BLOCK_LIMIT", 10)
    for scans in (None, 3):
        enc = _setup(tt.Encoder(90, device="cpu"), scans=scans)
        files = enc.encode_batch(imgs, 40, 24, tt.ColorType.RGB)
        assert enc.last_encode_path == "device-batch-per-image"
        one = _setup(tt.Encoder(90, device="cpu"), scans=scans)
        assert files == [one.encode(im, 40, 24, tt.ColorType.RGB)
                         for im in imgs]
        assert one.last_encode_path.startswith("device-chunked")


def _config(sf="F_1_1", restart=None, progressive=None, opt=False):
    return EncoderConfig(quality=90, sampling_factor=SamplingFactor[sf],
                         restart_interval=restart,
                         progressive_scans=progressive,
                         optimize_huffman_table=opt)


@pytest.mark.parametrize("n,w,h,config,route", [
    # The block limit, n * (w//8 + 1) * (h//8 + 1) <= 3,000,000.
    (8, 2000, 1800, _config(), SINGLE_PROGRAM),            # 453,808
    (52, 2000, 1800, _config(), SINGLE_PROGRAM),           # 2,949,752
    (53, 2000, 1800, _config(), PER_IMAGE),                # 3,006,478
    (1000, 799, 239, _config(), SINGLE_PROGRAM),           # 3,000,000
    (1001, 799, 239, _config(), PER_IMAGE),                # 3,003,000
    # The restart interval must divide each image's MCUs (56,250 here).
    (4, 2000, 1800, _config(restart=50), SINGLE_PROGRAM),
    (4, 2000, 1800, _config(restart=64), PER_IMAGE),
    # 4:2:0: 125 x 113 = 14,125 MCUs.
    (4, 2000, 1800, _config(sf="F_2_2", restart=25), SINGLE_PROGRAM),
    (4, 2000, 1800, _config(sf="F_2_2", restart=30), PER_IMAGE),
    # The mode and the tables.
    (4, 64, 64, _config(progressive=4), PER_IMAGE),
    (4, 64, 64, _config(opt=True), PER_IMAGE),
    (4, 64, 64, _config(progressive=4, opt=True), PER_IMAGE),
])
def test_batch_route(n, w, h, config, route):
    """The batch's plan at the route's boundaries, computed without
    encoding; its images' own route is encode()'s."""
    plan = make_plan(w, h, tt.ColorType.RGB, config, n=n)
    assert (plan.route, plan.image_route) == (route, "device-v2")


@pytest.mark.parametrize("config", [_config(restart=7), _config(progressive=2),
                                    _config(opt=True)],
                         ids=["ragged_restart", "progressive", "optimized"])
def test_route_functions_refuse_other_batches(config):
    """The single program raises for a batch it does not serve."""
    imgs = _images(2, 66, 34, 3, seed=0)
    params = tt.Encoder(90, device="cpu")._default_tables(config)[2]
    plan = make_plan(66, 34, tt.ColorType.RGB, config, n=len(imgs))
    assert plan.route == PER_IMAGE
    with pytest.raises(ValueError, match="single program"):
        de.device_encode_batch_single(imgs, plan, params)


def test_single_program_refuses_a_batch_of_another_size():
    """A single-program plan serves the number of images it was made for:
    a batch of another size raises before anything runs."""
    config = EncoderConfig(quality=90)
    imgs = _images(3, 16, 16, 3, seed=0)
    params = tt.Encoder(90, device="cpu")._default_tables(config)[2]
    plan = make_plan(16, 16, tt.ColorType.RGB, config, n=2)
    assert plan.route == SINGLE_PROGRAM and plan.n == 2
    with pytest.raises(ValueError, match="single program"):
        de.device_encode_batch_single(imgs, plan, params)
    de.device_encode_batch_single(imgs[:2], plan, params)


def test_batched_luma_keeps_its_width():
    """to_planes takes the batch axis from its caller: an (N, H, W) LUMA
    batch keeps W (it was stripped as a channel axis), and a tensor
    whose axes do not match the caller's statement raises."""
    px = torch.arange(2 * 3 * 5, dtype=torch.uint8).view(2, 3, 5)
    (plane,) = to_planes(px, tt.ColorType.LUMA, batched=True)
    assert torch.equal(plane, px.to(torch.int32))
    (plane,) = to_planes(px[0], tt.ColorType.LUMA)
    assert plane.shape == (3, 5)
    with pytest.raises(ValueError):
        to_planes(px, tt.ColorType.LUMA)
    with pytest.raises(ValueError):
        to_planes(px, tt.ColorType.RGB, batched=True)


@pytest.mark.parametrize("ct,ch,sf,scans", [
    ("RGB", 3, "F_1_1", None), ("RGB", 3, "F_2_2", None),
    ("YCCK", 4, "F_2_1", None), ("LUMA", 1, "F_1_1", None),
    ("RGB", 3, "F_4_1", 2), ("LUMA", 1, "F_2_2", 3),
])
def test_batched_streams_are_the_images_streams_in_turn(ct, ch, sf, scans):
    """fn_cm and fn_cm_samples over (N, H, W[, C]): the N images' streams
    one after another, in (image, MCU, block) column order for an
    interleaved scan, from one K1 per component."""
    w, h, n = 37, 21, 3
    config = EncoderConfig(quality=80, sampling_factor=SamplingFactor[sf],
                           progressive_scans=scans)
    params = tt.Encoder(80, device="cpu")._default_tables(config)[2]
    px = torch.from_numpy(np.stack(_images(n, w, h, ch, seed=ch)))
    args = (w, h, tt.ColorType[ct], config)
    q = (params.reciprocals, params.corrections)
    got = tpipe.fn_cm(px, *args, *q, batched=True)
    each = [tpipe.fn_cm(px[i], *args, *q) for i in range(n)]
    assert len(got) == len(each[0])
    for k, stream in enumerate(got):
        assert torch.equal(stream, torch.cat([e[k] for e in each], dim=1))
    if config.mode() == "interleaved":
        assert torch.equal(
            tpipe.fn_cm_samples(px, *args, batched=True),
            torch.cat([tpipe.fn_cm_samples(px[i], *args) for i in range(n)],
                      dim=1))


@settings(
    max_examples=int(os.environ.get("TPUENC_FUZZ_EXAMPLES", "6")),
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow],
)
@given(
    w=st.integers(1, 24),
    h=st.integers(1, 24),
    n=st.integers(1, 4),
    quality=st.integers(1, 100),
    ct=st.sampled_from(["LUMA", "RGB", "YCCK"]),
    optimized=st.booleans(),
    restart=st.sampled_from([0, 5]),
    seed=st.integers(0, 2**31),
)
def test_fuzz_encode_batch(w, h, n, quality, ct, optimized, restart, seed):
    """Twin of tests/test_fuzz.py::test_fuzz_encode_batch: encode_batch
    byte-identical to per-image encode and to tpuenc's encode_batch."""
    bpp = tt.ColorType[ct].bytes_per_pixel
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, size=w * h * bpp, dtype=np.uint8).tobytes()
            for _ in range(n)]

    def make(cls, **kw):
        enc = cls(quality, **kw)
        if optimized:
            enc.set_optimized_huffman_tables(True)
        if restart:
            enc.set_restart_interval(restart)
        return enc

    batch = make(tt.Encoder, device="cpu").encode_batch(
        imgs, w, h, tt.ColorType[ct])
    singles = [make(tt.Encoder, device="cpu").encode(im, w, h, tt.ColorType[ct])
               for im in imgs]
    assert batch == singles
    assert batch == make(tpuenc.Encoder).encode_batch(
        imgs, w, h, tpuenc.ColorType[ct])
