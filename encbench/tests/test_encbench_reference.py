"""The plain reference against the port's CPU path, and its control.

On small images of each cell's mode the reference gives the port's bytes;
with its transform in lower precision (8 fractional bits) it does not.
Nothing under ``encbench/`` imports JAX or ``tpuenc``, and the reference
imports nothing of ``tpuenc_torch``.
"""

import ast
import os

import numpy as np
import pytest

import tpuenc_torch as tt
from reference import jpeg
from tpuenc_torch import api

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, color type, channels, sampling, progressive scans, optimized)
MODES = [
    ("interleaved-444", "rgb", 3, (1, 1), None, False),
    ("progressive-opt", "rgb", 3, (1, 1), 4, True),
    ("sequential-opt-420", "rgb", 3, (2, 2), None, True),
    ("ycck-420", "cmyk_as_ycck", 4, (2, 2), None, False),
]
SIZES = [(64, 48), (45, 37)]


def port_encoder(samp, scans, opt):
    enc = tt.Encoder(90, device="cpu")
    enc.set_sampling_factor(tt.SamplingFactor.from_factors(*samp))
    if scans:
        enc.set_progressive_scans(scans)
    enc.set_optimized_huffman_tables(opt)
    return enc


def image(w, h, c, seed):
    rng = np.random.default_rng(seed)
    base = np.add.outer(np.arange(h), np.arange(w))[..., None] * 3 % 256
    noise = rng.integers(-30, 30, (h, w, c))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def ref(img, ct, samp, scans, opt, const_bits=13):
    return jpeg.encode(img, color_type=ct, quality=90, sampling=samp,
                       progressive_scans=scans, optimize_tables=opt,
                       const_bits=const_bits)


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("mode", MODES, ids=[m[0] for m in MODES])
def test_reference_is_the_port(mode, w, h):
    _, ct, c, samp, scans, opt = mode
    img = image(w, h, c, w * h)
    got = port_encoder(samp, scans, opt).encode(img, w, h, tt.ColorType(ct))
    assert got == ref(img, ct, samp, scans, opt)


@pytest.mark.parametrize("interval", [1, 3])
@pytest.mark.parametrize("mode", MODES + [
    ("interleaved-420", "rgb", 3, (2, 2), None, False),
    ("progressive-420", "rgb", 3, (2, 2), 3, False)],
    ids=[m[0] for m in MODES] + ["interleaved-420", "progressive-420"])
def test_reference_is_the_port_with_restarts(mode, interval):
    _, ct, c, samp, scans, opt = mode
    img = image(45, 37, c, interval)
    enc = port_encoder(samp, scans, opt)
    enc.set_restart_interval(interval)
    got = enc.encode(img, 45, 37, tt.ColorType(ct))
    want = jpeg.encode(img, color_type=ct, quality=90, sampling=samp,
                       progressive_scans=scans, optimize_tables=opt,
                       restart_interval=interval)
    assert want.count(b"\xff\xdd") == 1 and b"\xff\xd0" in want
    assert got == want


def test_reference_is_the_port_batch():
    imgs = [image(64, 48, 3, s) for s in range(3)]
    enc = port_encoder((1, 1), None, False)
    got = enc.encode_batch(imgs, 64, 48, tt.ColorType.RGB)
    assert enc.last_encode_path == "device-batch"
    assert got == [ref(im, "rgb", (1, 1), None, False) for im in imgs]


def test_reference_is_the_port_chunked(monkeypatch):
    monkeypatch.setattr(api, "DEVICE_BLOCK_LIMIT", 0)
    img = image(80, 72, 4, 7)
    enc = port_encoder((2, 2), None, False)
    got = enc.encode(img, 80, 72, tt.ColorType.CMYK_AS_YCCK)
    assert enc.last_encode_path == "device-chunked"
    # several chunks: the stream's bands and the reference's bands differ
    pieces = list(enc.encode_stream(img, 80, 72, tt.ColorType.CMYK_AS_YCCK,
                                    chunk_mcu_rows=1))
    assert len(pieces) > 3 and b"".join(pieces) == got
    assert got == ref(img, "cmyk_as_ycck", (2, 2), None, False)


@pytest.mark.parametrize("interval", [None, 5])
def test_reference_bands_do_not_change_the_bytes(monkeypatch, interval):
    img = image(96, 80, 4, 3)
    kw = dict(color_type="cmyk_as_ycck", quality=90, sampling=(2, 2),
              restart_interval=interval)
    whole = jpeg.encode(img, **kw)
    monkeypatch.setattr(jpeg, "BAND_BLOCKS", 37)
    assert jpeg.encode(img, **kw) == whole


@pytest.mark.parametrize("mode", MODES, ids=[m[0] for m in MODES])
def test_lower_precision_transform_disagrees(mode):
    _, ct, c, samp, scans, opt = mode
    img = image(64, 48, c, 11)
    got = port_encoder(samp, scans, opt).encode(img, 64, 48, tt.ColorType(ct))
    assert got != ref(img, ct, samp, scans, opt, const_bits=8)


def imported_top_names(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_or_tpuenc_imports():
    banned = {"jax", "jaxlib", "flax", "tpuenc"}
    for path in sources():
        assert not imported_top_names(path) & banned, path


def test_reference_imports_nothing_of_the_port():
    for path in sources("reference"):
        names = imported_top_names(path)
        assert "tpuenc_torch" not in names and not names & {"harness"}, path


def test_loaded_check_compares_top_names_whole():
    from harness import bench

    assert bench.banned_loaded(["tpuenc_torch", "tpuenc_torch.api",
                                "jaxtyping", "torch"]) == []
    assert bench.banned_loaded(["tpuenc.api", "jax.numpy", "numpy"]) == [
        "jax", "tpuenc"]
