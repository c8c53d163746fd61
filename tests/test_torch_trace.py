"""tpuenc_torch.tracing on the CPU: off by default and free while off;
when on, one request per entry call, the stage spans nested under it on
every route, the counters, the profiler's annotations, the bytes
unchanged and the kept requests bounded."""

from __future__ import annotations

import ast
import glob
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpuenc_torch as tt
from tpuenc_torch import plan as planning
from tpuenc_torch import tracing
from tpuenc_torch.entropy import device_encode as de

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 40, 24
IMG = np.random.default_rng(3).integers(0, 256, (H, W, 3), np.uint8)
RGB = tt.ColorType.RGB

# Every span name the port opens, documented in tracing's docstring.
STAGES = {"encode", "plan", "upload", "transform", "histograms", "tables",
          "pack", "sync.meta", "sync.hist", "sync.counts", "sync.bytes",
          "sync.rows", "finish.device",
          "finish.host", "finish.stream", "assemble", "multipass.store",
          "multipass.scan"}


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts and ends with the tracer off."""
    tracing.disable()
    try:
        yield
    finally:
        tracing.disable()


@pytest.fixture
def chunked(monkeypatch):
    """The chunked routes at a small size: the whole-image limit at 0."""
    monkeypatch.setattr(planning, "DEVICE_BLOCK_LIMIT", 0)


def _encoder(**settings):
    enc = tt.Encoder(90, device="cpu")
    for key, value in settings.items():
        getattr(enc, f"set_{key}")(value)
    return enc


def _plain(enc):
    return enc.encode(IMG, W, H, RGB)


def _batch(enc):
    return enc.encode_batch([IMG, IMG[::-1].copy()], W, H, RGB)


def _stream(enc):
    return b"".join(enc.encode_stream(IMG, W, H, RGB, chunk_mcu_rows=1))


# (route, settings, call, its entry, last_encode_path, the stages of a
# warm call)
ROUTES = [
    ("device-v2", {}, _plain, "encode", "device-v2",
     {"plan", "upload", "transform", "pack", "sync.meta", "finish.device",
      "sync.counts", "sync.bytes", "assemble"}),
    ("progressive-optimized",
     {"progressive": True, "optimized_huffman_tables": True}, _plain,
     "encode", "device-v2",
     {"plan", "upload", "transform", "histograms", "sync.hist", "tables",
      "pack", "sync.meta", "finish.device", "sync.counts", "sync.bytes",
      "assemble"}),
    ("batch", {}, _batch, "encode_batch", "device-batch",
     {"plan", "upload", "transform", "pack", "sync.meta", "finish.device",
      "sync.counts", "sync.bytes", "assemble"}),
    ("chunked", {}, _plain, "encode", "device-chunked",
     {"plan", "transform", "upload", "pack", "sync.meta", "finish.stream",
      "sync.counts", "sync.bytes", "assemble"}),
    ("chunked-multipass", {"optimized_huffman_tables": True,
                           "progressive": True}, _plain,
     "encode", "device-chunked-multipass",
     {"plan", "transform", "upload", "histograms", "sync.hist", "tables",
      "pack", "sync.meta", "finish.stream", "sync.counts", "sync.bytes",
      "assemble", "multipass.store", "multipass.scan"}),
    ("stream", {}, _stream, "encode_stream", "device-chunked-stream",
     {"plan", "transform", "upload", "pack", "sync.meta", "finish.stream",
      "sync.counts", "sync.bytes"}),
]
IDS = [r[0] for r in ROUTES]

# The chunked multipass route's stages that run inside one of its passes:
# the stage -> the spans it may sit right under (every other stage sits
# under its request's encode span, as on every other route).  The
# optimized tables' upload runs between the passes.
PASSES = {"transform": {"multipass.store"}, "histograms": {"multipass.store"},
          "upload": {"multipass.store", "encode"},
          "pack": {"multipass.scan"}, "sync.meta": {"multipass.scan"},
          "finish.stream": {"multipass.scan"},
          "sync.counts": {"multipass.scan"}, "sync.bytes": {"multipass.scan"}}


def _setup(request, route):
    if route.startswith("chunked"):
        request.getfixturevalue("chunked")


def _nested(req):
    """Every span lies inside its parent, in time and in the list."""
    (top,) = [i for i, s in enumerate(req.spans) if s.parent is None][:1]
    assert top == 0 and req.spans[0].name == "encode"
    for i, s in enumerate(req.spans):
        assert s.request == req.id and s.start <= s.end
        if s.parent is None:
            assert s.name == "encode"
            continue
        p = req.spans[s.parent]
        assert s.parent < i and p.start <= s.start and s.end <= p.end


def test_off_by_default_and_free():
    fresh = subprocess.run(
        [sys.executable, "-c", "from tpuenc_torch import tracing as t; "
         "assert t.span('pack') is t.span('upload') is t.request('encode')"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert fresh.returncode == 0, fresh.stderr
    before = len(tracing.requests())
    assert tracing.span("pack", rung=4) is tracing.span("upload")
    assert tracing.request("encode") is tracing.span("assemble")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _plain(_encoder())
    assert len(tracing.requests()) == before
    names = {e.name for e in prof.events()}
    assert not any(n in STAGES or n.split(":")[-1] in STAGES for n in names)


def test_off_reads_no_clock_and_enters_no_annotation(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("read while tracing is off")

    want = _plain(_encoder())
    monkeypatch.setattr(tracing, "perf_counter_ns", forbidden)
    monkeypatch.setattr(tracing, "record_function", forbidden)
    assert _plain(_encoder()) == want
    assert _batch(_encoder())[0] == want
    with tracing.request("encode"), tracing.span("pack"):
        tracing.count("syncs")


@pytest.mark.parametrize("route,settings,call,entry,path,stages", ROUTES,
                         ids=IDS)
def test_one_request_per_call_spans_nested(request, route, settings, call,
                                           entry, path, stages):
    _setup(request, route)
    enc = _encoder(**settings)
    off = call(enc)  # warm: tables uploaded, rung learned
    tracing.enable()
    on = call(enc)
    (req,) = tracing.requests()
    assert on == off and enc.last_encode_path == path
    assert req.entry == entry
    _nested(req)
    assert {s.name for s in req.spans if s.parent is not None} == stages
    # a warm call's stages sit right under its request's encode spans, or
    # under the multipass route's pass that runs them
    under = PASSES if path == "device-chunked-multipass" else {}
    for s in req.spans:
        if s.parent is not None:
            assert req.spans[s.parent].name in under.get(s.name,
                                                         {"encode"}), s
    packs = [s for s in req.spans if s.name == "pack"]
    assert all(s.ints["rung"] in de.BUDGET_LADDER and s.ints["blocks"] > 0
               for s in packs)
    # syncs: each blocking read and each upload
    blocking = [s for s in req.spans
                if s.name.startswith("sync.") or s.name == "upload"]
    assert req.counters["syncs"] == len(blocking)
    # a pack kept for each chunk, each chunk finished on the device, or
    # the one pack of a whole-image route
    kept = (req.counters["device_finished_chunks"]
            if "chunked" in path else 1)
    assert kept == sum(s.name == "sync.counts" for s in req.spans)
    assert req.counters.get("ladder_retries", 0) == len(packs) - kept


@pytest.mark.parametrize("route,settings,call,entry,path,stages", ROUTES,
                         ids=IDS)
def test_assembled_bytes_are_the_files_bytes(request, route, settings, call,
                                             entry, path, stages):
    """Each file is gathered once, by the assembly: a request counts the
    bytes of the files it returns.  A stream hands its pieces over as it
    makes them, and gathers none."""
    _setup(request, route)
    enc = _encoder(**settings)
    call(enc)
    tracing.enable()
    out = call(enc)
    (req,) = tracing.requests()
    files = out if isinstance(out, list) else [out]
    if "assemble" in stages:
        assert req.counters["assembled_bytes"] == sum(map(len, files)) > 0
    else:
        assert "assembled_bytes" not in req.counters


# A warm call's file (the first 16 hex digits of the sha256 of its bytes,
# a batch's files joined) and its ``syncs``, as the port gave them with a
# pageable upload: staging the pixels changes neither.
PINNED = {
    "device-v2": ("e0d88085bd88acd8", 4),
    "progressive-optimized": ("c8c1a95559936185", 7),
    "batch": ("e3c5b2574619288f", 5),
    "chunked": ("e0d88085bd88acd8", 4),
    "chunked-multipass": ("c8c1a95559936185", 40),
    "stream": ("e0d88085bd88acd8", 12),
}


@pytest.mark.parametrize("route,settings,call,entry,path,stages", ROUTES,
                         ids=IDS)
def test_cpu_routes_keep_their_bytes_and_syncs_and_stage_nothing(
        request, route, settings, call, entry, path, stages):
    """On the CPU no route stages a slab (``upload_slabs`` counts 0), every
    route's bytes are those of the pageable upload, and each ``upload``
    still counts one of the call's ``syncs``."""
    import hashlib

    _setup(request, route)
    enc = _encoder(**settings)
    call(enc)
    tracing.enable()
    out = call(enc)
    (req,) = tracing.requests()
    files = out if isinstance(out, list) else [out]
    digest = hashlib.sha256(b"".join(files)).hexdigest()[:16]
    assert (digest, req.counters["syncs"]) == PINNED[route]
    assert req.counters.get("upload_slabs", 0) == 0


def test_cold_calls_put_their_table_uploads_under_plan():
    tracing.enable()
    _plain(_encoder())
    (req,) = tracing.requests()
    _nested(req)
    under = [req.spans[s.parent].name for s in req.spans
             if s.name == "upload" and s.parent]
    assert "plan" in under
    assert req.counters["syncs"] == sum(
        s.name.startswith("sync.") or s.name == "upload" for s in req.spans)


@pytest.mark.parametrize("route", ["device-v2", "chunked"])
def test_a_forced_climb_counts_its_retries(request, route):
    """Noise at q100 from the lowest rung: every pack but the last
    overflows."""
    _setup(request, route)
    de._budget_memo.clear()
    noise = np.random.default_rng(9).integers(0, 256, (64, 64, 3), np.uint8)
    enc = tt.Encoder(100, device="cpu")
    tracing.enable()
    enc.encode(noise, 64, 64, RGB)
    (req,) = tracing.requests()
    packs = [s for s in req.spans if s.name == "pack"]
    assert len(packs) > 1
    assert req.counters["ladder_retries"] == len(packs) - 1
    assert [s.ints["rung"] for s in packs] == sorted(
        s.ints["rung"] for s in packs)
    assert enc.last_budget == packs[-1].ints["rung"]


def _segments_in(out: bytes) -> int:
    """The file's restart segments: one a scan, and one more for each RST
    marker (inside a scan's data a 0xFF byte is stuffed or a marker)."""
    return out.count(b"\xff\xda") + len(re.findall(rb"\xff[\xd0-\xd7]", out))


def _420(interval, **settings):
    enc = _encoder(**settings)
    enc.set_sampling_factor(tt.SamplingFactor.from_factors(2, 2))
    enc.set_restart_interval(interval)
    return enc


# 40x24 at 4:2:0 is 3 x 2 = 6 MCUs: the interval -> its segments
RESTARTS = [(0, 1), (1, 6), (4, 2), (6, 1), (100, 1)]


@pytest.mark.parametrize("interval,segments", RESTARTS)
def test_a_restart_encode_counts_its_segments(interval, segments):
    enc = _420(interval)
    tracing.enable()
    out = _plain(enc)
    (req,) = tracing.requests()
    assert enc.last_encode_path == "device-v2"
    assert req.counters["restart_segments"] == segments == _segments_in(out)


def test_a_progressive_encode_counts_one_segment_a_scan():
    enc = _encoder(progressive=True, optimized_huffman_tables=True)
    tracing.enable()
    out = _plain(enc)
    (req,) = tracing.requests()
    scans = out.count(b"\xff\xda")
    assert scans > 3 and req.counters["restart_segments"] == scans


@pytest.mark.parametrize("settings", [
    {}, {"progressive": True, "optimized_huffman_tables": True}],
    ids=["interleaved", "multipass"])
@pytest.mark.parametrize("interval,segments", RESTARTS)
def test_a_chunked_encode_counts_its_segments(chunked, settings, interval,
                                              segments):
    enc = _420(interval, **settings)
    tracing.enable()
    out = _plain(enc)
    (req,) = tracing.requests()
    assert enc.last_encode_path.startswith("device-chunked")
    assert req.counters["restart_segments"] == _segments_in(out)
    if not settings:
        assert req.counters["restart_segments"] == segments


def test_annotations_match_the_spans(tmp_path):
    enc = _encoder()
    _plain(enc)
    tracing.enable(annotate="port:")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _plain(enc)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = sorted(((float(e["ts"]), float(e["dur"]), e["name"][5:])
                    for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("port:")),
                   key=lambda m: (m[0], -m[1]))
    (req,) = tracing.requests()
    order = sorted(range(len(req.spans)),
                   key=lambda i: (req.spans[i].start, -req.spans[i].end))
    assert [m[2] for m in marks] == [req.spans[i].name for i in order]
    mark = dict(zip(order, marks))
    # the same intervals on the profiler's clock: each mark lies inside
    # its parent's, after its elder sibling's, and lasts as long as its
    # span (the profiler's clock may run a few percent off the host's)
    for i, s in enumerate(req.spans):
        ts, dur, _ = mark[i]
        if s.parent is not None:
            pts, pdur, _ = mark[s.parent]
            assert pts <= ts and ts + dur <= pts + pdur
        older = [j for j in range(i) if req.spans[j].parent == s.parent]
        if older:
            ots, odur, _ = mark[older[-1]]
            assert ots + odur <= ts
        if s.ns >= 5e6:
            assert abs(dur - s.ns / 1e3) <= 0.25 * s.ns / 1e3 + 2000


def test_keep_bounds_the_requests():
    enc = _encoder()
    tracing.enable(keep=3)
    for _ in range(5):
        _plain(enc)
    kept = tracing.requests()
    assert len(kept) == 3
    ids = [r.id for r in kept]
    assert ids == sorted(ids) and ids[-1] - ids[0] == 2
    tracing.enable(keep=2)
    assert tracing.requests() == []
    with pytest.raises(ValueError):
        tracing.enable(keep=0)


def test_a_stream_holds_no_span_across_a_yield(chunked):
    enc = _encoder()
    want = _plain(enc)
    tracing.enable()
    pieces = enc.encode_stream(IMG, W, H, RGB, chunk_mcu_rows=1)
    got = [next(pieces)]
    for piece in pieces:  # another call between the stream's pieces
        got.append(piece)
        assert _plain(_encoder()) == want
    assert b"".join(got) == want
    reqs = tracing.requests()
    (stream,) = [r for r in reqs if r.entry == "encode_stream"]
    assert len(reqs) == 1 + len(got) - 1
    _nested(stream)
    tops = [s for s in stream.spans if s.parent is None]
    assert len(tops) == len(got) + 1  # one a resumption
    assert all(s.name == "encode" for s in tops)


def test_concurrent_callers_do_not_interleave():
    enc_by_thread = [_encoder() for _ in range(6)]
    want = _plain(enc_by_thread[0])
    for enc in enc_by_thread:  # warm, so that every call has one shape
        _plain(enc)
    errors = []

    def client(enc):
        try:
            for _ in range(3):
                assert _plain(enc) == want
        except Exception as e:  # reported below
            errors.append(e)

    tracing.enable()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(e,))
                   for e in enc_by_thread]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    reqs = tracing.requests()
    assert len(reqs) == 18 and len({r.id for r in reqs}) == 18
    for req in reqs:
        _nested(req)
        assert [s.name for s in req.spans] == [s.name for s in reqs[0].spans]


def test_a_nested_request_is_a_span_and_a_lone_span_records_nothing():
    tracing.enable()
    with tracing.span("pack"):
        tracing.count("syncs")
    assert tracing.requests() == []
    with tracing.request("outer") as req:
        with tracing.request("encode"):
            tracing.count("ladder_retries", 2)
    assert tracing.requests() == [req]
    assert [(s.name, s.parent) for s in req.spans] == [("encode", None),
                                                       ("encode", 0)]
    assert req.counters == {"ladder_retries": 2}


def _port_span_names():
    """The literal names the port passes to tracing.span / request."""
    names = set()
    pat = re.compile(r'tracing\.span\("([^"]+)"')
    for path in glob.glob(os.path.join(ROOT, "tpuenc_torch", "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            names |= set(pat.findall(f.read()))
    return names | {"encode"}


def test_span_names_are_documented_and_apart_from_the_benchmark():
    names = _port_span_names()
    assert names == STAGES
    for name in names:
        assert f"``{name}``" in tracing.__doc__ or (
            name.startswith("sync.")
            and f"``{name[5:]}``" in tracing.__doc__), name
    taken = set()
    for path in glob.glob(os.path.join(ROOT, "encbench", "metrics", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in tree.body:
            if (isinstance(node, ast.Assign)
                    and [t.id for t in node.targets
                         if isinstance(t, ast.Name)] == ["SPANS"]):
                taken |= set(ast.literal_eval(node.value))
    assert taken and not names & taken


def test_the_port_never_names_its_benchmark():
    for path in glob.glob(os.path.join(ROOT, "tpuenc_torch", "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            assert "encbench" not in f.read(), path


def test_launches_are_the_wrappers_counters(monkeypatch):
    """A request's launches are the wrappers' own counts over it."""
    from tpuenc_torch.kernels import pallas_fdct

    enc = _encoder()
    _plain(enc)
    tracing.enable()
    with tracing.request("encode") as req:
        pallas_fdct.fdct_quantize.launches += 3
    assert req.launches["fdct_quantize"] == 3
    assert set(req.launches) == {fn.__name__
                                 for fn in tracing.kernel_wrappers()}
    assert sum(req.launches.values()) == 3
