"""tpuenc_torch whole files against tpuenc and the frozen fixtures, on the
CPU (the kernels' plain versions), byte for byte."""

from __future__ import annotations

import io
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import tpuenc  # noqa: E402
import tpuenc_torch as tt  # noqa: E402
from tpuenc_torch.testing.fixtures import build_cases, img  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CASES = build_cases("cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_interleaved_fixtures(name):
    """All 26 frozen fixtures (interleaved, sequential, progressive,
    optimized tables), byte for byte."""
    build, ct, ch, seed, w, h = CASES[name]
    want = open(os.path.join(HERE, "fixtures", f"{name}.jpg"), "rb").read()
    enc = build()
    assert enc.encode(img(ch, seed, w, h).tobytes(), w, h, ct) == want
    assert enc.last_encode_path == "device-v2"


def _setup(enc, sampling, restart, q, scans=None, opt=False):
    enc.set_sampling_factor(sampling)
    if restart:
        enc.set_restart_interval(restart)
    if q:
        enc.set_quantization_tables(*q)
    if scans:
        enc.set_progressive_scans(scans)
    if opt:
        enc.set_optimized_huffman_tables(True)
    return enc


def _pixels(w, h, ch, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 3 + yy * 5)[..., None] % 256
    noise = rng.integers(-30, 30, (h, w, ch))
    px = np.clip(base + noise, 0, 255).astype(np.uint8)
    return px[..., 0] if ch == 1 else px


def _case(w, h, ct, ch, quality, sf, restart, q, scans=None, opt=False, id=None):
    return pytest.param(w, h, ct, ch, quality, sf, restart, q, scans, opt,
                        id=id or f"{w}-{h}-{ct}-{ch}-{quality}-{sf}-{restart}-{q}")


@pytest.mark.parametrize("w,h,ct,ch,quality,sf,restart,q,scans,opt", [
    _case(64, 48, "rgb", 3, 90, "F_1_1", 0, None),
    _case(64, 48, "rgba", 4, 75, "F_2_2", 3, None),
    _case(64, 48, "ycck", 4, 92, "F_2_1", 0, ("image_magick", "flat"),
          id="64-48-ycck-4-92-F_2_1-0-q2"),
    _case(258, 172, "rgb", 3, 90, "F_1_1", 0, None),
    _case(258, 172, "bgr", 3, 70, "F_2_2", 7, None),
    _case(258, 172, "luma", 1, 100, "F_1_1", 1, None),
    _case(64, 48, "rgb", 3, 90, "F_1_1", 0, None, 2, id="progressive2"),
    _case(64, 48, "rgb", 3, 90, "F_1_1", 0, None, 4, id="progressive4"),
    _case(64, 48, "rgb", 3, 90, "F_1_1", 0, None, 34, id="progressive34"),
    _case(64, 48, "rgb", 3, 90, "F_1_1", 0, None, 64, id="progressive64"),
    _case(64, 48, "ycck", 4, 85, "F_2_2", 2, None, 5,
          id="progressive5_restart2_ycck420"),
    _case(64, 48, "rgb", 3, 85, "F_4_1", 3, None, id="sequential_f41"),
    _case(64, 48, "rgb", 3, 95, "F_2_2", 0, None, None, True,
          id="optimized_sequential"),
    _case(64, 48, "rgb", 3, 88, "F_2_1", 4, None, 6, True,
          id="optimized_progressive6_restart4"),
])
def test_matches_tpuenc(w, h, ct, ch, quality, sf, restart, q, scans, opt,
                        monkeypatch):
    """Whole files == tpuenc's.  tpuenc's CPU device path packs a 34- or
    64-scan plan too slowly for this suite; those two cases take its host
    path, which its own tests hold byte-identical to the device path."""
    if scans and scans > 16:
        monkeypatch.setenv("TPUENC_DEVICE_ENTROPY", "0")
    px = _pixels(w, h, ch, w * h + quality)
    want = _setup(tpuenc.Encoder(quality), tpuenc.SamplingFactor[sf],
                  restart, q, scans, opt).encode(px, w, h, tpuenc.ColorType(ct))
    enc = _setup(tt.Encoder(quality, device="cpu"), tt.SamplingFactor[sf],
                 restart, q, scans, opt)
    assert enc.encode(px, w, h, tt.ColorType(ct)) == want


def test_optimized_tables_follow_each_image():
    """Two different images through one optimized-table Encoder: each file
    carries and uses its own K.2 tables (the Huffman tensors are not
    cached with the quantizers)."""
    imgs = [_pixels(48, 40, 3, 1), np.random.default_rng(2).integers(
        0, 256, (40, 48, 3), np.uint8)]
    enc = tt.Encoder(90, device="cpu")
    enc.set_progressive_scans(3)
    enc.set_optimized_huffman_tables(True)
    outs = []
    for px in imgs:
        ref = tpuenc.Encoder(90)
        ref.set_progressive_scans(3)
        ref.set_optimized_huffman_tables(True)
        want = ref.encode(px, 48, 40, tpuenc.ColorType.RGB)
        outs.append(enc.encode(px, 48, 40, tt.ColorType.RGB))
        assert outs[-1] == want
    dht = [o[o.index(b"\xff\xc4"):o.index(b"\xff\xda")] for o in outs]
    assert dht[0] != dht[1]


def test_pack_rows_count_every_scan():
    """The whole-image limit counts one pack row per block per scan: a
    64-scan 4096x4096 RGB plan has 50M rows and routes to the chunked
    multipass path, a 2-scan plan of the same image stays whole."""
    enc = tt.Encoder(90, device="cpu")
    enc.set_progressive_scans(64)
    plan = enc._plan(4096, 4096, tt.ColorType.RGB)
    assert plan.pack_rows == 512 * 512 * 3 * 64
    assert plan.route == "device-chunked-multipass"
    enc.set_progressive_scans(2)
    assert enc._plan(4096, 4096, tt.ColorType.RGB).route == "device-v2"


def test_import_leaves_out_jax():
    """Importing the port and encoding (split and fused, each through the
    device finish, through the chunked path with the limit forced down,
    and streamed), and importing the striped encode (``tpuenc_torch.shard``)
    and its launcher, loads neither jax nor tpuenc."""
    code = (
        "import sys, numpy as np, tpuenc_torch as t\n"
        "from tpuenc_torch import plan\n"
        "px = np.zeros((8, 8, 3), np.uint8)\n"
        "for f in (False, True):\n"
        "    t.Encoder(90, device='cpu', fused_p1=f).encode("
        "px, 8, 8, t.ColorType.RGB)\n"
        "plan.DEVICE_BLOCK_LIMIT = 0\n"
        "e = t.Encoder(90, device='cpu')\n"
        "e.encode(px, 8, 8, t.ColorType.RGB)\n"
        "assert e.last_encode_path == 'device-chunked', e.last_encode_path\n"
        "b''.join(e.encode_stream(px, 8, 8, t.ColorType.RGB))\n"
        "import tpuenc_torch.shard.encode, tpuenc_torch.shard.dryrun\n"
        "import tpuenc_torch.testing.dist, tpuenc_torch.testing.shard_cases\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tpuenc')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("setup,match", [
    (lambda e: e.set_progressive(True), "M6"),
    (lambda e: e.set_optimized_huffman_tables(True), "M7"),
    (lambda e: e.set_sampling_factor(tt.SamplingFactor.F_4_1), "M6"),
])
def test_unsupported_modes_raise(setup, match):
    """The modes that raised NotImplementedError naming ``match`` before
    ROADMAP M6 and M7 were ported now encode, equal to tpuenc."""
    px = np.random.default_rng(len(match)).integers(0, 256, (16, 16, 3),
                                                     np.uint8)
    enc = tt.Encoder(90, device="cpu")
    setup(enc)
    ref = tpuenc.Encoder(90)
    setup(ref)
    assert enc._config().mode() != "interleaved"
    want = ref.encode(px, 16, 16, tpuenc.ColorType.RGB)
    assert enc.encode(px, 16, 16, tt.ColorType.RGB) == want


def test_unsupported_entry_points_raise():
    """The entry points that raised NotImplementedError naming M8 and M9
    now encode: encode_batch and encode_stream return encode's bytes, and
    a 16384x16384 image routes to the chunked path."""
    enc = tt.Encoder(90, device="cpu")
    px = np.zeros((16, 16, 3), np.uint8)
    want = enc.encode(px, 16, 16, tt.ColorType.RGB)
    assert enc.encode_batch([px], 16, 16, tt.ColorType.RGB) == [want]
    assert b"".join(enc.encode_stream(px, 16, 16, tt.ColorType.RGB)) == want
    assert enc._plan(16384, 16384, tt.ColorType.RGB).route == \
        "device-chunked"


def test_device_is_required():
    with pytest.raises(TypeError):
        tt.Encoder(90)


def test_error_surfaces():
    enc = tt.Encoder(90, device="cpu")
    with pytest.raises(tt.BadImageData):
        enc.encode(b"\0" * 10, 4, 4, tt.ColorType.RGB)
    with pytest.raises(tt.ZeroImageDimensions):
        enc.encode(b"", 0, 4, tt.ColorType.RGB)
    with pytest.raises(tt.InvalidAppSegment):
        enc.add_app_segment(0, b"x")
    with pytest.raises(tt.AppSegmentTooLarge):
        enc.add_app_segment(3, b"x" * 65534)


def test_sinks_and_image_buffer(tmp_path):
    px = img(3, 0)
    want = open(os.path.join(HERE, "fixtures", "baseline_q90_444.jpg"), "rb").read()
    path = tmp_path / "out.jpg"
    tt.Encoder.new_file(path, 90, device="cpu").encode(px, 26, 19, tt.ColorType.RGB)
    assert path.read_bytes() == want
    sink = io.BytesIO()
    tt.Encoder.new_writer(sink, 90, device="cpu").encode(
        px, 26, 19, tt.ColorType.RGB)
    assert sink.getvalue() == want

    class RgbPlanes(tt.ImageBuffer):
        def get_jpeg_color_type(self):
            return tt.JpegColorType.YCBCR

        def color_type(self):
            return tt.ColorType.RGB

        def width(self):
            return 26

        def height(self):
            return 19

        def to_planes(self):
            return tuple(px[..., i] for i in range(3))

    assert tt.Encoder(90, device="cpu").encode_image(RgbPlanes()) == want


@pytest.mark.parametrize("w,h,ct,sf,restart,quality", [
    (1, 1, "rgb", "F_1_1", 0, 90),
    (1, 1, "luma", "F_2_2", 1, 50),
    (7, 3, "rgb", "F_2_2", 0, 80),
    (17, 1, "cmyk", "F_2_1", 1, 85),
    (1, 17, "ycck", "F_1_2", 2, 70),
    (9, 9, "bgra", "F_2_2", 5, 100),
    (33, 2, "cmyk_as_ycck", "F_2_2", 3, 1),
    (40, 40, "ycbcr", "F_1_1", 7, 95),
])
def test_odd_geometry_matches_tpuenc(w, h, ct, sf, restart, quality):
    """Images smaller than one block or one MCU, one pixel wide or tall,
    with restart intervals of 1 and more: padding, partial MCUs, DC resets."""
    ch = tt.ColorType(ct).bytes_per_pixel
    px = np.random.default_rng(w * 100 + h).integers(0, 256, (h, w, ch), np.uint8)

    def setup(mod, **kw):
        e = mod.Encoder(quality, **kw)
        e.set_sampling_factor(mod.SamplingFactor[sf])
        e.set_restart_interval(restart)
        return e

    want = setup(tpuenc).encode(px, w, h, tpuenc.ColorType(ct))
    assert setup(tt, device="cpu").encode(px, w, h, tt.ColorType(ct)) == want


@pytest.mark.parametrize("w,h,ct,sf,restart,scans,opt", [
    (1, 1, "rgb", "F_1_1", 0, 64, False),
    (1, 1, "luma", "F_2_2", 1, 3, True),
    (7, 3, "rgb", "F_4_1", 0, None, True),
    (17, 1, "cmyk", "F_2_1", 1, 34, False),
    (9, 9, "bgra", "F_1_4", 5, None, False),
    (33, 2, "cmyk_as_ycck", "F_2_2", 3, 2, True),
])
def test_odd_geometry_modes_match_tpuenc(w, h, ct, sf, restart, scans, opt,
                                         monkeypatch):
    """Sequential and progressive files and optimized tables on images
    smaller than one block or one MCU: single-block component streams,
    streams far below one packing tile, restart intervals of 1."""
    if scans and scans > 16:  # see test_matches_tpuenc
        monkeypatch.setenv("TPUENC_DEVICE_ENTROPY", "0")
    ch = tt.ColorType(ct).bytes_per_pixel
    px = np.random.default_rng(w * 100 + h).integers(0, 256, (h, w, ch), np.uint8)

    def setup(mod, **kw):
        e = mod.Encoder(85, **kw)
        e.set_sampling_factor(mod.SamplingFactor[sf])
        e.set_restart_interval(restart)
        if scans:
            e.set_progressive_scans(scans)
        e.set_optimized_huffman_tables(opt)
        return e

    want = setup(tpuenc).encode(px, w, h, tpuenc.ColorType(ct))
    assert setup(tt, device="cpu").encode(px, w, h, tt.ColorType(ct)) == want
