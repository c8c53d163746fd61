"""The harness on the CPU: the contract of BENCHMARK.json, the files each
cell is made of, its inputs, window, statistics and trace arithmetic."""

import json
import os
import re
import statistics
import time

import numpy as np
import pytest
import torch

from harness import bench, cells, inputs, work
from harness.spans import Spans
from harness.trace import DeviceTrace, covered, union

SPEC = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def small(cell, **size):
    c = dict(cell["config"], **size)
    c["content"] = dict(c["content"], pool=min(c["content"]["pool"], 3))
    return dict(cell, config=c)


def test_contract_keys_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + WORKLOADS + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [False, True])
def test_every_cell_finds_its_files(workload, trace):
    cell = cells.cell(SPEC, workload, trace)
    assert cell["config"]["name"] == cell["workload"]["config"]
    assert cell["traffic"]["entry"] in ("encode", "encode_batch")
    want = [m["name"] for m in SPEC["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]
    assert [n for n, _, _ in cell["metrics"]] == want
    for name, _, reader in cell["metrics"]:
        assert callable(reader.read), name
    assert any(n == "throughput_mps" or trace for n, _, _ in cell["metrics"])


@pytest.mark.parametrize("workload", ["photo-baseline", "ycck16k-chunked"])
def test_inputs_repeat_from_a_seed(workload):
    cfg = small(cells.cell(SPEC, workload, False), width=40,
                height=24)["config"]
    a = inputs.make(cfg, 2**31 + 5, "cpu")
    b = inputs.make(cfg, 2**31 + 5, "cpu")
    c = inputs.make(cfg, 2**31 + 6, "cpu")
    assert len(a) == cfg["content"]["pool"]
    assert all(x.dtype == np.uint8 and x.shape == (24, 40, cfg["channels"])
               for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    if cfg["content"]["pool"] > 1:
        assert not np.array_equal(a[0], a[1])


class Sleeper:
    """A program whose every call takes ``dt`` seconds."""

    def __init__(self, dt, k=1):
        self.dt, self.k, self.calls = dt, k, 0

    def __call__(self, images):
        self.calls += 1
        time.sleep(self.dt)
        return [b"x"] * len(images)


def test_window_closes_on_a_whole_call(monkeypatch):
    monkeypatch.setattr(bench.check, "compare",
                        lambda *a: ({"differing_files": {"value": 0,
                                                         "limit": 0}}, 1, 0.0,
                                    1.0))
    cell = small(cells.cell(SPEC, "photo-baseline", False), width=16,
                 height=16)
    prog = Sleeper(0.05)
    t = time.perf_counter()
    result, _ = bench.run_cell(cell, 3, 0.12, False, "cpu", t, program=prog)
    n = result["attempted"]
    # the call that crossed 0.12 s ran to its end: 3 calls of 0.05 s
    assert n == 3 and prog.calls == n + 2 * 3  # + the warm-up, twice a pool
    rate = result["metrics"]["throughput_mps"]["value"]
    window = n * 16 * 16 / rate / 1e6
    assert 0.15 <= window < 0.15 + 0.03
    assert result["metrics"]["latency_p95_ms"]["value"] >= 50


def run_of(**kw):
    base = dict(calls=4, pixels_per_call=2_000_000, window_s=2.0,
                latencies=[0.1] * 19 + [0.9], setup_s=1.5, peak_bytes=2**21,
                spans={}, trace=None, images_per_call=1, profiled_calls=0)
    base.update(kw)
    return bench.Run(**base)


def test_rate_is_every_pixel_over_the_window():
    reader = cells.metric_reader("throughput_mps")
    assert reader.read(run_of()) == pytest.approx(4 * 2.0 / 2.0)


def test_p95_is_over_every_call():
    reader = cells.metric_reader("latency_p95_ms")
    # 20 calls: the 19th smallest is the nearest-rank 95th percentile
    assert reader.read(run_of()) == pytest.approx(100.0)
    lat = list(np.linspace(0.001, 0.2, 200))
    assert reader.read(run_of(latencies=lat)) == pytest.approx(
        1e3 * sorted(lat)[189])
    assert reader.read(run_of(latencies=[0.5])) == pytest.approx(500.0)


def test_peak_and_setup_readers():
    assert cells.metric_reader("peak_device_mib").read(run_of()) == 2.0
    assert cells.metric_reader("peak_device_mib").read(
        run_of(peak_bytes=None)) is None
    assert cells.metric_reader("setup_s").read(run_of()) == 1.5


def trace_of(ops, spans, window=(0.0, 100.0)):
    """A DeviceTrace from (name, cat, start, end, launch) ops and (name,
    start, end) spans, as the profiler's Chrome trace holds them."""
    events = [{"ph": "X", "cat": "user_annotation",
               "name": "encbench.subwindow", "ts": window[0],
               "dur": window[1] - window[0]}]
    for k, (name, cat, a, b, launch) in enumerate(ops):
        events.append({"ph": "X", "cat": cat, "name": name, "ts": a,
                       "dur": b - a, "args": {"correlation": k}})
        if launch is not None:
            events.append({"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaLaunchKernel", "ts": launch,
                           "dur": 1, "args": {"correlation": k}})
    for name, a, b in spans:
        events.append({"ph": "X", "cat": "user_annotation",
                       "name": "encbench:" + name, "ts": a, "dur": b - a})
    return DeviceTrace(events)


def test_union_of_device_intervals():
    assert union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]
    assert covered([(0, 2), (1, 3), (50, 60)], 2, 55) == pytest.approx(6)
    tr = trace_of([("k1", "kernel", 10, 30, 5), ("k2", "kernel", 20, 40, 6),
                   ("m", "gpu_memcpy", 90, 120, 80)], [])
    assert tr.busy_us() == pytest.approx(40)
    reader = cells.metric_reader("device_idle_pct")
    assert reader.read(run_of(trace=tr)) == pytest.approx(60.0)
    assert cells.metric_reader("device_idle_pct").read(run_of()) is None


def test_launches_and_attribution():
    tr = trace_of([("k1", "kernel", 10, 30, 5), ("k2", "kernel", 32, 40, 31),
                   ("copy HtoD", "gpu_memcpy", 41, 45, 29),
                   ("k3", "kernel", 50, 70, 45), ("k4", "kernel", 80, 85, None)],
                  [("coefficients", 0, 20), ("entropy", 25, 46),
                   ("pack", 28, 35), ("finish", 75, 99)])
    assert [op[0] for op in tr.launched_in({"coefficients"})] == ["k1"]
    # copies to and from the host are not the stage's work
    assert [op[0] for op in tr.launched_in({"entropy"})] == ["k2", "k3"]
    assert tr.unattributed() == 1
    r = cells.metric_reader("launches_per_mp").read(
        run_of(trace=tr, profiled_calls=1, pixels_per_call=1_000_000))
    assert r == 5.0
    gaps = dict(tr.idle_gaps())
    # idle: 0..10, 30..32, 40..41, 45..50, 70..80, 85..100
    assert gaps["coefficients"] == pytest.approx(10e-6)
    assert gaps["pack"] == pytest.approx(2e-6)  # inside entropy
    assert gaps["entropy"] == pytest.approx(1e-6 + 1e-6)  # 40..41, 45..46
    # 46..50, 70..75, 99..100
    assert gaps["between spans"] == pytest.approx(4e-6 + 5e-6 + 1e-6)
    assert gaps["finish"] == pytest.approx(5e-6 + 14e-6)  # 75..80, 85..99
    assert sum(gaps.values()) == pytest.approx((100 - 20 - 8 - 4 - 20 - 5)
                                               * 1e-6)
    assert tr.top_ops()[0] == ("k1", pytest.approx(20e-6))


def test_roofline_work_counts():
    cfg = cells.cell(SPEC, "photo-baseline", False)["config"]
    ycck = cells.cell(SPEC, "ycck16k-chunked", False)["config"]
    plain = cells.cell(SPEC, "photo-baseline", False)["traffic"]
    prog = cells.cell(SPEC, "photo-progressive-opt", False)["traffic"]
    assert work.coded_blocks(cfg, plain) == 250 * 225 * 3 == 168_750
    assert work.coded_blocks(cfg, prog) == 168_750
    assert work.coded_blocks(ycck, plain) == 1024 * 1024 * 10 == 10_485_760
    # odd sizes: 4:2:0 MCUs pad, separate scans crop each component's grid
    odd = dict(cfg, width=17, height=9, encoder={
        "quality": 90, "sampling_factor": {"SamplingFactor.from_factors":
                                           [2, 2]}})
    assert work.coded_blocks(odd, plain) == 2 * 1 * 6
    assert work.coded_blocks(odd, prog) == 3 * 2 + 2 * (2 * 1)
    assert work.coefficient_bytes(cfg, plain) == 2000 * 1800 * 3 \
        + 168_750 * 128
    assert work.coefficient_bytes(ycck, plain) == 16384 ** 2 * 4 \
        + 10_485_760 * 128
    assert work.entropy_bytes(cfg, plain, 1000) == 168_750 * 128 + 1000
    assert work.entropy_bytes(cfg, prog, 1000) == 2 * 168_750 * 128 + 1000
    tr = trace_of([("k", "kernel", 0, 10, 1)], [("coefficients", 0, 5)])
    share = cells.metric_reader("coefficients_roofline").read(run_of(
        trace=tr, config=cfg, traffic=plain, profiled_calls=1))
    least_us = work.coefficient_bytes(cfg, plain) / work.HBM_BYTES_PER_S * 1e6
    assert share == pytest.approx(100 * least_us / 10)


def test_settings_reach_the_port_and_the_reference_by_name():
    from harness import check

    cell = cells.cell(SPEC, "photo-progressive-opt", False)
    traffic = dict(cell["traffic"], encoder=dict(
        cell["traffic"]["encoder"], restart_interval=4, progressive_scans=3))
    port = bench.Port(cell["config"], traffic, "cpu")
    assert (port.enc.progressive_scans(), port.enc.restart_interval(),
            port.enc.optimized_huffman_tables()) == (3, 4, True)
    assert check.reference_kwargs(cell["config"], traffic) == {
        "color_type": "rgb", "quality": 90, "progressive_scans": 3,
        "optimize_tables": True, "restart_interval": 4, "sampling": (1, 1)}
    ycck = cells.cell(SPEC, "ycck16k-chunked", False)
    assert check.reference_kwargs(ycck["config"], ycck["traffic"])[
        "sampling"] == (2, 2)
    assert bench.Port(ycck["config"], ycck["traffic"], "cpu").enc \
        .sampling_factor().name == "F_2_2"
    with pytest.raises(ValueError, match="no setting"):
        check.reference_kwargs(cell["config"], dict(traffic, encoder={
            "quantization_tables": ["flat", "flat"]}))


def test_scan_bytes_of_a_file():
    import tpuenc_torch as tt

    img = np.full((16, 16, 3), 128, np.uint8)
    enc = tt.Encoder(90, device="cpu")
    enc.set_progressive(True)
    f = enc.encode(img, 16, 16, tt.ColorType.RGB)
    parts = f.split(b"\xff\xda")[1:]
    heads = sum((p[0] << 8) | p[1] for p in parts)
    assert bench.scan_bytes(f) == sum(map(len, parts)) - heads - 2
    assert 0 < bench.scan_bytes(f) < len(f)


def test_spans_wrap_every_binding_and_restore():
    from tpuenc_torch import api
    from tpuenc_torch.entropy import chunked, device_encode
    from tpuenc_torch.kernels import pipeline

    real = (pipeline.fn_cm, chunked.fn_cm, api.Encoder._assemble_scans)
    spans = Spans({"c": ["tpuenc_torch.kernels.pipeline:fn_cm"],
                   "a": ["tpuenc_torch.api:Encoder._assemble_scans"],
                   "f": ["tpuenc_torch.entropy.device_stuff:device_stuff"]})
    with spans:
        assert pipeline.fn_cm is not real[0] and chunked.fn_cm is not real[1]
        assert device_encode.stuff_on_device.__wrapped__ is not None
        import tpuenc_torch as tt

        img = np.zeros((16, 16, 3), np.uint8)
        tt.Encoder(90, device="cpu").encode(img, 16, 16, tt.ColorType.RGB)
    assert (pipeline.fn_cm, chunked.fn_cm, api.Encoder._assemble_scans) == real
    assert not hasattr(device_encode.stuff_on_device, "__wrapped__")
    assert spans.counts["c"] == spans.counts["a"] == spans.counts["f"] == 1
    assert all(v > 0 for v in spans.seconds.values())


def test_spans_count_the_outermost_call_only():
    from tpuenc_torch.core import tables

    spans = Spans({"t": ["tpuenc_torch.core.tables:quantization_table",
                         "tpuenc_torch.core.tables:_finish_table"]})
    with spans:
        tables.quantization_table("default", 90, True)
    assert spans.counts["t"] == 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_cell_on_the_card(card, trace):
    cell = small(cells.cell(SPEC, "photo-baseline", trace), width=640,
                 height=480)
    result, _ = bench.run_cell(cell, 17, 1.0, trace, card,
                               time.perf_counter())
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        for name in ("coefficients_roofline", "entropy_roofline",
                     "device_idle_pct", "launches_per_mp"):
            assert name in result["metrics"], name
        for name in ("coefficients_roofline", "entropy_roofline"):
            assert 0 < result["metrics"][name]["value"] <= 100
    else:
        assert statistics.fmean([result["metrics"]["peak_device_mib"]
                                 ["value"]]) > 0


def test_run_refuses_without_a_card(tmp_path):
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(cells.BENCH, "run.py"), "--workload",
         "photo-baseline", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
