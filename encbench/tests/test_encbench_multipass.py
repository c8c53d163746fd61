"""The cells ``ycck16k-multipass`` and ``photo-q100`` on the CPU: their
files and metrics found by name, the settings the reference reads, the
work counts, the three readers of the chunked multipass route's spans and
counter (silent on a port or a route without them), and a traced run of
each at a small size."""

import importlib
import time

import pytest

from harness import bench, cells, check, work
from tpuenc_torch import tracing

SPEC = cells.load_benchmark()
STORE = ["store_pass_ms_per_mp", "scan_pass_ms_per_mp",
         "store_mib_per_call"]


@pytest.fixture(autouse=True)
def program():
    """``harness.program``, imported here (its import turns the tracer
    on), and the tracer off after the test."""
    try:
        yield importlib.import_module("harness.program")
    finally:
        tracing.disable()


@pytest.mark.parametrize("workload,traffic,config", [
    ("ycck16k-multipass", "encode-whole-opt", "ycck16k-opt"),
    ("photo-q100", "encode-q100", "photo-2000x1800")])
def test_the_cells_find_their_files_and_metrics(workload, traffic, config):
    e2e = cells.cell(SPEC, workload, False)
    assert e2e["workload"]["traffic"] == traffic
    assert e2e["workload"]["chips"] == 1
    assert e2e["config"]["name"] == config
    assert e2e["traffic"]["entry"] == "encode"
    names = [n for n, _, _ in e2e["metrics"]]
    latency = ["latency_p95_ms"] if workload == "photo-q100" else []
    assert names == ["throughput_mps", *latency, "peak_device_mib",
                     "setup_s"]
    traced = [n for n, _, _ in cells.cell(SPEC, workload, True)["metrics"]]
    photo = [n for n, _, _ in cells.cell(SPEC, "photo-baseline",
                                         True)["metrics"]]
    if workload == "photo-q100":
        assert traced == photo
    else:
        assert traced == photo + STORE
    for entry in SPEC["per_layer"]:
        if entry["name"] in STORE:
            assert entry["workloads"] == ["ycck16k-multipass"]
            assert entry["moves"] == "throughput_mps"


def test_the_reference_reads_each_cells_settings():
    mp = cells.cell(SPEC, "ycck16k-multipass", False)
    q = cells.cell(SPEC, "photo-q100", False)
    assert check.reference_kwargs(mp["config"], mp["traffic"]) == {
        "color_type": "cmyk_as_ycck", "quality": 90, "sampling": (2, 2),
        "optimize_tables": True}
    assert check.reference_kwargs(q["config"], q["traffic"]) == {
        "color_type": "rgb", "quality": 100, "sampling": (1, 1)}
    enc = bench.Port(q["config"], q["traffic"], "cpu").enc
    assert enc.sampling_factor().name == "F_1_1"
    assert bench.Port(mp["config"], mp["traffic"],
                      "cpu").enc.optimized_huffman_tables()


def test_the_work_of_each_cell():
    mp = cells.cell(SPEC, "ycck16k-multipass", False)
    q = cells.cell(SPEC, "photo-q100", False)
    # each component's own grid: 2 x 2048^2 + 2 x 1024^2
    assert work.coded_blocks(mp["config"], mp["traffic"]) == 10_485_760
    assert work.entropy_bytes(mp["config"], mp["traffic"], 1000) == \
        2 * 10_485_760 * 128 + 1000
    assert work.coded_blocks(q["config"], q["traffic"]) == 168_750
    assert work.entropy_bytes(q["config"], q["traffic"], 1000) == \
        168_750 * 128 + 1000


def run_of(calls):
    return bench.Run(calls=calls, pixels_per_call=2_000_000,
                     images_per_call=1, traffic={"takes": "image"})


def request(spans, counters):
    """A request with spans of the given (name, ms) and counters."""
    req = tracing.Request("encode")
    t = 0
    for name, ms in [("encode", 10.0)] + spans:
        span = tracing.Span(name, None if name == "encode" else 0, req.id,
                            {})
        span.start, span.end = t, t + int(ms * 1e6)
        req.spans.append(span)
        t = span.end if name != "encode" else t
    req.counters.update(counters)
    return req


def test_the_readers_and_their_silence(monkeypatch):
    read = {n: cells.metric_reader(n).read for n in STORE}
    kept = [request([("multipass.store", 4.0), ("multipass.scan", 1.0),
                     ("multipass.scan", 0.5), ("pack", 2.0)],
                    {"store_bytes": 3 * 2**20, "syncs": 9})] * 2
    monkeypatch.setattr(tracing, "requests", lambda: list(kept))
    # 2 calls of 2 MP: 2 x 4 ms over 4 MP; 2 x 1.5 ms
    assert read["store_pass_ms_per_mp"](run_of(2)) == pytest.approx(2.0)
    assert read["scan_pass_ms_per_mp"](run_of(2)) == pytest.approx(0.75)
    assert read["store_mib_per_call"](run_of(2)) == pytest.approx(3.0)
    # another route, or a port from before the spans and the counter
    kept[:] = [request([("transform", 1.0), ("pack", 1.0)],
                       {"syncs": 4})] * 2
    for name in STORE:
        assert read[name](run_of(2)) is None, name
        assert read[name](run_of(3)) is None, name  # fewer kept than calls
    monkeypatch.setattr(importlib.import_module("harness.program"),
                        "tracing", None)
    for name in STORE:
        assert read[name](run_of(2)) is None, name


def small(cell, w, h):
    c = dict(cell["config"], width=w, height=h)
    c["content"] = dict(c["content"], pool=2)
    return dict(cell, config=c)


def test_a_traced_cpu_run_of_the_multipass_cell(monkeypatch):
    from tpuenc_torch import plan as planning

    monkeypatch.setattr(planning, "DEVICE_BLOCK_LIMIT", 0)
    cell = small(cells.cell(SPEC, "ycck16k-multipass", True), 64, 48)
    tracing.enable()
    result, _ = bench.run_cell(cell, 2**31 + 24, 0.2, True, "cpu",
                               time.perf_counter())
    assert result["correct"] and result["failed"] == 0
    got = {k: v["value"] for k, v in result["metrics"].items()}
    # Y and K 8 x 6 = 48 blocks, Cb and Cr 4 x 3 = 12, each padded to a
    # pack chunk of 256: 4 x 256 blocks of 128 bytes
    assert got["store_mib_per_call"] == 4 * 256 * 128 / 2**20
    assert got["restart_segments_per_call"] == 4
    assert got["store_pass_ms_per_mp"] > 0 and got["scan_pass_ms_per_mp"] > 0


def test_a_cpu_run_of_the_q100_cell():
    cell = small(cells.cell(SPEC, "photo-q100", True), 48, 32)
    tracing.enable()
    result, _ = bench.run_cell(cell, 2**31 + 100, 0.2, True, "cpu",
                               time.perf_counter())
    assert result["correct"] and result["failed"] == 0
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert not set(STORE) & set(got)
    assert got["restart_segments_per_call"] == 1
