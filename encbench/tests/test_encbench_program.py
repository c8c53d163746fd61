"""The per-layer metrics that read the port's own tracer
(``harness.program``, ``tpuenc_torch.tracing``) on the CPU: the window's
requests and each reader's number.  The tracer is turned off after every
test, so that it is not left on in this process."""

import importlib
import time

import numpy as np
import pytest

from harness import bench, cells
from tpuenc_torch import tracing

SPEC = cells.load_benchmark()
READERS = {
    "upload_ms_per_mp": 1.0,             # 2 x 2 ms over 2 calls of 2 MP
    "coefficients_host_ms_per_mp": 1.5,  # 2 x 3 ms
    "pack_host_ms_per_mp": 1.0,          # 2 x (1 + 1) ms
    "sync_wait_ms_per_mp": 0.375,        # 2 x (0.5 + 0.25) ms
    "syncs_per_call": 5.0,               # 2 x 5 over 2 calls
    "ladder_retries_per_call": 1.0,      # 2 x 1 over 2 calls
}


@pytest.fixture(autouse=True)
def program():
    """``harness.program``, imported here (its import turns the tracer
    on), and the tracer off after the test."""
    try:
        yield importlib.import_module("harness.program")
    finally:
        tracing.disable()


def run_of(**kw):
    base = dict(calls=2, pixels_per_call=2_000_000, images_per_call=1,
                traffic={"takes": "image"})
    base.update(kw)
    return bench.Run(**base)


def synthetic(entry="encode"):
    """A request with spans of known length (ms) and counters."""
    req = tracing.Request(entry)
    t = 0
    for name, ms in (("encode", 8.0), ("upload", 2.0), ("transform", 3.0),
                     ("pack", 1.0), ("pack", 1.0), ("sync.meta", 0.5),
                     ("sync.bytes", 0.25), ("assemble", 0.125)):
        span = tracing.Span(name, None if name == "encode" else 0, req.id,
                            {})
        span.start, span.end = t, t + int(ms * 1e6)
        req.spans.append(span)
        t = span.end if name != "encode" else t
    req.counters.update(syncs=5, ladder_retries=1)
    return req


def test_the_window_is_the_last_calls_requests(program, monkeypatch):
    kept = [synthetic() for _ in range(10)]
    monkeypatch.setattr(tracing, "requests", lambda: list(kept))
    assert program.window(run_of(calls=3)) == kept[-3:]
    # one request an image where a call hands the entry one image each
    assert program.window(run_of(calls=3, images_per_call=2)) == kept[-6:]
    # one request a call where a call hands over its images at once
    assert program.window(run_of(calls=3, images_per_call=8,
                                 traffic={"takes": "images"})) == kept[-3:]
    assert program.window(run_of(calls=10)) == kept
    assert program.window(run_of(calls=11)) is None  # keep fell short
    assert program.window(run_of(calls=0)) is None
    monkeypatch.setattr(program, "tracing", None)  # a port with no tracer
    assert program.window(run_of(calls=3)) is None
    for name in READERS:
        assert cells.metric_reader(name).read(run_of(calls=3)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_from_synthetic_requests(program, monkeypatch, name):
    kept = [synthetic() for _ in range(3)]
    monkeypatch.setattr(tracing, "requests", lambda: list(kept))
    assert cells.metric_reader(name).read(run_of()) == pytest.approx(
        READERS[name])


def test_the_window_of_real_calls(program):
    import tpuenc_torch as tt

    img = np.random.default_rng(0).integers(0, 256, (16, 24, 3), np.uint8)
    enc = tt.Encoder(90, device="cpu")
    tracing.enable(keep=3)
    for _ in range(5):
        enc.encode(img, 24, 16, tt.ColorType.RGB)
    kept = tracing.requests()
    assert [r.id for r in kept] == sorted(r.id for r in kept)
    assert program.window(run_of(calls=2)) == kept[-2:]
    assert program.window(run_of(calls=3)) == kept
    assert program.window(run_of(calls=4)) is None


def small(cell, **size):
    c = dict(cell["config"], **size)
    c["content"] = dict(c["content"], pool=min(c["content"]["pool"], 2))
    return dict(cell, config=c)


# Syncs a call on a warm encoder: the upload, the ladder's meta, the
# device finish's counts and bytes; the two-pass mode adds its counts'
# read and the optimized tables' two uploads; the single program uploads
# each of its 8 slots and reads its meta and its stream.
@pytest.mark.parametrize("workload,syncs", [
    ("photo-baseline", 4), ("photo-progressive-opt", 7),
    ("photo-batch8", 10)])
def test_a_traced_cpu_cell_reports_them(program, workload, syncs):
    cell = small(cells.cell(SPEC, workload, True), width=48, height=32)
    names = [n for n, _, _ in cell["metrics"]]
    assert set(READERS) <= set(names)
    tracing.enable()
    result, _ = bench.run_cell(cell, 2**31 + 11, 0.2, True, "cpu",
                               time.perf_counter())
    assert result["correct"] and result["failed"] == 0
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert got["syncs_per_call"] == syncs
    assert got["ladder_retries_per_call"] == 0  # the rung was learned
    for name in ("upload_ms_per_mp", "coefficients_host_ms_per_mp",
                 "pack_host_ms_per_mp", "sync_wait_ms_per_mp"):
        assert got[name] > 0, name
    assert result["metrics"]["syncs_per_call"]["unit"] == "syncs/call"
